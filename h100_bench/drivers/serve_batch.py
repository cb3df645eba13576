"""Batched serving: one client converts a directory of simulated scans in
batches (a closed loop), as ``cli/inference.py --source_dir --batch_size
B`` does once its model is loaded: normalise each pair's clouds on the
host, copy the batch in, run ``guided_sample_loop`` on B clouds at once
(the grid takes them flat-batched), copy the answers out and take each
back to its source's frame.

The traffic file gives the pool of scene pairs drawn at set-up
(``pool_pairs``), the clouds a call (``batch``), the sampler's ``steps``
and ``guidance``, and the calls a traced run profiles
(``trace_requests``). Call i takes B distinct pairs' ``sim`` clouds as its
sources, each restyled toward another pair's ``real`` cloud, all chosen
from the seed, and its draws from ``drivers/serve.py::draws_of`` (a
generator on the card seeded for the call, in the sampler's [B, ...]
shapes); the reference takes cloud j's share of them. A call counts B
units.

The check (``workloads/<cell>.json``: ``requests``, the clouds compared,
and ``limits``) compares clouds drawn from the seed among those the window
finished against ``reference/sampler.py``, as ``serve.py``'s does; this
module carries its own ``reference_answer`` and the functions that call
it. A traced run also records the program's spans
(``core/span_log.py``) where every span reader finds them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import compare, program_spans, seeds
from ..core import trace as tracing
from ..core.harness import mark
from ..core.span_log import span_log
from ..reference import request as ref_request
from ..reference import sampler as ref_sampler
from .serve import (build, draws_of, hierarchical,  # noqa: F401
                    print_segments, release, sample_call)

Key = Tuple[int, int]  # (call, cloud of the call)


def pairs_of(run, i: int) -> List[tuple]:
    """(source pair, reference pair) of each cloud of call i: B distinct
    sources, each with another pair as its reference."""
    P, B = run.cell.traffic["pool_pairs"], run.cell.traffic["batch"]
    rng = seeds.numpy_rng(run.seed, "call", i)
    sources = rng.choice(P, B, replace=False)
    return [(int(a), (int(a) + 1 + int(rng.integers(P - 1))) % P)
            for a in sources]


def request(run, i: int) -> dict:
    """Call i, timed on the host: each answer is kept for the check."""
    from pointcloud_style_transfer_torch.data.preprocessing import (
        denormalize_point_cloud, normalize_point_cloud)
    pairs = pairs_of(run, i)
    t_start = time.perf_counter()
    with record_function("request.normalize"):
        srcs, params, refs = [], [], []
        for a, b in pairs:
            s, p = normalize_point_cloud(run.state["sims"][a])
            srcs.append(s)
            params.append(p)
            refs.append(normalize_point_cloud(run.state["reals"][b])[0])
    with record_function("request.copy_in"):
        src = torch.from_numpy(np.stack(srcs)).to(run.device)
        ref = torch.from_numpy(np.stack(refs)).to(run.device)
    with record_function("request.draws"):
        draws = draws_of(run, i)
    t_call = time.perf_counter()
    with record_function("request.sampler_call"):
        out = sample_call(run, src, ref, draws)
    t_return = time.perf_counter()
    with record_function("request.copy_out"):
        host = out.cpu().numpy()
        for j, p in enumerate(params):
            run.state["answers"][(i, j)] = denormalize_point_cloud(
                host[j], p).astype(np.float32)
    run.state["last_out"] = out
    t_end = time.perf_counter()
    return {"id": i, "t_start": t_start, "t_call": t_call,
            "t_return": t_return, "t_end": t_end,
            "units": run.cell.traffic["batch"]}


def setup(run) -> None:
    build(run)
    for i in (-1, -2):  # the sampler's key: eager, then captured
        request(run, i)
        mark(run, f"warm-up {-i}")
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def window(run) -> None:
    records: List[dict] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        records.append(request(run, i))
        i += 1
        if records[-1]["t_end"] - t0 >= run.seconds:
            break
    run.records = records
    run.window_s = records[-1]["t_end"] - t0
    run.attempted, run.failed = len(records), 0
    run.state["next_id"] = i
    print_segments(records, t0)


def trace(run) -> None:
    n = run.cell.traffic["trace_requests"]

    def stretch() -> int:
        for _ in range(n):
            request(run, run.state["next_id"])
            run.state["next_id"] += 1
        return n
    run.trace_summary = tracing.profile(stretch, run.device)
    run.state[program_spans.KEY] = span_log(run, request)


def checked_ids(run) -> List[Key]:
    """The finished clouds the check compares, drawn from the seed."""
    B = run.cell.traffic["batch"]
    done = [(r["id"], j) for r in run.records for j in range(B)]
    k = min(run.cell.check["requests"], len(done))
    rng = seeds.numpy_rng(run.seed, "check")
    return sorted(done[int(n)] for n in rng.choice(len(done), k,
                                                   replace=False))


def reference_answer(run, key: Key, precision: str = "fp32") -> tuple:
    """(the reference's answer to cloud j of call i in its source's
    normalised frame, that frame's (centre, scale))."""
    cfg, tr = run.cell.config, run.cell.traffic
    i, j = key
    a, b = pairs_of(run, i)[j]
    src_n, params = ref_request.normalize(run.state["sims"][a],
                                          cfg["target_range"])
    ref_n, _ = ref_request.normalize(run.state["reals"][b],
                                     cfg["target_range"])
    d = {k: v[:, j] if k in ("step_priorities", "fps_starts") else v[j]
         for k, v in draws_of(run, i).items()}
    out = ref_sampler.guided_transfer(
        run.state["weights"], cfg, torch.from_numpy(src_n).to(run.device),
        torch.from_numpy(ref_n).to(run.device), d, tr["steps"],
        tr["guidance"], hierarchical(run), precision)
    return out.cpu().numpy(), params


def answers_of(run, key: Key) -> List[np.ndarray]:
    return [run.state["answers"][key]]


def checked_pairs(run, answers=answers_of, controls=()) -> Dict[str, list]:
    """``serve.checked_pairs`` over this module's clouds and reference."""
    out = {name: [] for name in ("program", *controls)}
    for key in checked_ids(run):
        ref, params = reference_answer(run, key)
        e_floor = compare.point_errors(
            reference_answer(run, key, "bf16")[0], ref)
        for a in answers(run, key):
            out["program"].append((compare.point_errors(
                ref_request.to_normalized(a, params), ref), e_floor))
        for p in controls:
            out[p].append((compare.point_errors(
                reference_answer(run, key, p)[0], ref), e_floor))
    return out


def check(run, answers=answers_of) -> List[dict]:
    """The compared numbers (``serve.check``'s)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = checked_pairs(run, answers)["program"]
    return compare.numbers(compare.serve_readings(pairs),
                           run.cell.check["limits"])
