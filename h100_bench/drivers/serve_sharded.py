"""Serving on several cards as one program: ``serve``'s requests through
``guided_sample_loop(mesh=...)`` on the traffic file's ``mesh`` (such as
``{"points": 4}``), one process a card. Every rank takes the same clouds
and draws, interpolates its share of the unknown points and denoises its
share of the coarse rows, and the shares are all-gathered each step inside
the captured loop; every rank returns the whole cloud.

``launch`` starts the ranks (``torch.distributed`` over NCCL, its
rendezvous on a free localhost port), waits for all of them and relays
their output, rank 0's result last. The ranks agree after every request
whether the window is over, so that all of them serve the same requests.
Rank 0 reports: the card memory peak of the fullest rank, the device busy
time averaged over the ranks, its own trace for the breakdown, and the
check of every rank's answer against the reference.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List

import torch
import torch.distributed as dist

from . import serve
from ..core import trace as tracing
from ..core.harness import BENCH_DIR

T0_ENV = "H100_BENCH_T0"  # the launcher's clock at its start


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, cell, t_start: float) -> int:
    """Run one process a card; relay their output, rank 0's result last.
    Returns 0 when every rank did."""
    world, port = cell.chips, free_port()
    logs = tempfile.mkdtemp(prefix="h100_bench_ranks_")
    procs = []
    for rank in range(world):
        # NCCL's shared-memory transport is not needed between cards joined
        # by NVLink, and a run writes nothing to /dev/shm
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), NCCL_SHM_DISABLE="1",
                   **{T0_ENV: repr(t_start)})
        cmd = [sys.executable, str(BENCH_DIR / "run.py"),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(rank)]
        out = open(os.path.join(logs, f"rank{rank}.out"), "w")
        err = open(os.path.join(logs, f"rank{rank}.err"), "w")
        procs.append((subprocess.Popen(cmd, stdout=out, stderr=err,
                                       env=env), out, err))
    rcs = []
    try:
        for p, out, err in procs:
            rcs.append(p.wait())
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()

    def text(rank: int, kind: str) -> str:
        with open(os.path.join(logs, f"rank{rank}.{kind}")) as f:
            return f.read()
    for rank in list(range(1, world)) + [0]:
        sys.stderr.write(f"--- rank {rank} (exit {rcs[rank]}) ---\n")
        sys.stderr.write(text(rank, "err"))
    sys.stderr.flush()
    if any(rcs):
        return 1
    sys.stdout.write(text(0, "out"))
    sys.stdout.flush()
    for name in os.listdir(logs):
        os.remove(os.path.join(logs, name))
    os.rmdir(logs)
    return 0


def setup(run) -> None:
    from pointcloud_style_transfer_torch.parallel import make_mesh
    if T0_ENV in os.environ:
        run.t_start = float(os.environ[T0_ENV])
    run.state["mesh"] = make_mesh(dict(run.cell.traffic["mesh"]),
                                  run.device.type)
    serve.setup(run)


def _agree_done(run, done: bool) -> bool:
    """Whether any rank's window is over (then every rank's is)."""
    flag = torch.tensor([int(done)], device=run.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def window(run) -> None:
    records: List[dict] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        records.append(serve.request(run, i))
        i += 1
        if _agree_done(run, records[-1]["t_end"] - t0 >= run.seconds):
            break
    run.records = records
    run.window_s = records[-1]["t_end"] - t0
    run.attempted, run.failed = len(records), 0
    run.state["next_id"] = i
    serve.print_segments(records, t0)


def memory_peak(run) -> int:
    peak = torch.tensor([torch.cuda.max_memory_allocated(run.device)],
                        device=run.device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return int(peak.item())


def trace(run) -> None:
    summary = tracing.profile(serve.trace_stretch(run), run.device)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (summary.busy_s, summary.window_s))
    summary.all_busy_s = sum(b for b, _ in every) / len(every)
    summary.all_window_s = sum(w for _, w in every) / len(every)
    run.trace_summary = summary


def release(run) -> None:
    """Every rank's checked answers to every rank; the graphs (which hold
    the communicator) and the model freed; the reference's answers to the
    checked requests worked out a share a rank and gathered; then the
    process group goes."""
    from pointcloud_style_transfer_torch.models import capture
    ids = serve.checked_ids(run)
    n, me = dist.get_world_size(), dist.get_rank()
    every = [None] * n
    dist.all_gather_object(every, {i: run.state["answers"][i] for i in ids})
    run.state["rank_answers"] = every
    capture.release()
    run.state.pop("mesh", None)
    serve.release(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mine = {i: serve.reference_pair(run, i) for i in ids[me::n]}
    parts = [None] * n
    dist.all_gather_object(parts, mine)
    run.state["references"] = {i: r for part in parts
                               for i, r in part.items()}
    dist.destroy_process_group()


def answers_of(run, i: int) -> list:
    return [answers[i] for answers in run.state["rank_answers"]]


def reports(run) -> bool:
    return run.state.get("rank", 0) == 0


def check(run) -> list:
    if not reports(run):
        return []
    return serve.check(run, answers_of)
