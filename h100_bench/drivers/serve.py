"""Serving: one client sends one request at a time (a closed loop), as
``cli/inference.py``'s ``DiffusionInference.transfer_style_hierarchical``
serves a pair once its model is loaded: normalise both clouds on the host,
copy them in, run ``guided_sample_loop``, copy the answer out and take it
back to the source's frame.

The traffic file gives the pool of scene pairs drawn at set-up
(``pool_pairs``), the sampler's ``steps`` and ``guidance``, and how many
requests a traced run profiles (``trace_requests``). Request i takes the
``sim`` cloud of one pair as its source and the ``real`` cloud of another
as its style reference, both chosen from the seed, and its draws (initial
noise, voxel priorities, FPS starts) from a generator on the card seeded
for it; the benchmark hands the same draws to the reference.

The check (``workloads/<cell>.json``: ``requests``, ``limits``) runs the
plain reference over a sample of the finished requests drawn from the seed
and compares each answer point by point (``core.compare``).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..core import compare, seeds, weights
from ..core.harness import mark
from ..core import trace as tracing
from ..reference import request as ref_request
from ..reference import sampler as ref_sampler
from ..traffic import lidar_pairs


def port_config(cfg: dict):
    """The port's ``Config`` with the configuration file's values."""
    from pointcloud_style_transfer_torch import Config
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in known})


def load_net(model, w: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the program's network, every tensor
    named (BatchNorm's batch counters stay at 0)."""
    net = model.net
    state = dict(w)
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(t)
    net.load_state_dict(state, strict=True)


def hierarchical(run) -> bool:
    cfg = run.cell.config
    return bool(cfg["use_hierarchical"]) and \
        cfg["total_points"] > cfg["global_points"]


def pair_of(run, i: int) -> tuple:
    """(source pair, reference pair) of request i: two distinct pairs."""
    P = run.cell.traffic["pool_pairs"]
    rng = seeds.numpy_rng(run.seed, "request", i)
    a = int(rng.integers(P))
    return a, (a + 1 + int(rng.integers(P - 1))) % P


def draws_of(run, i: int) -> Dict[str, torch.Tensor]:
    """Request i's draws, on the device, in the sampler's shapes: the
    condition cloud's voxel priorities, the two FPS starts, the initial
    noise and each step's voxel priorities (hierarchical)."""
    cfg, tr = run.cell.config, run.cell.traffic
    N = Nc = cfg["total_points"]
    M, B, steps = cfg["global_points"], tr["batch"], tr["steps"]
    dev = run.device
    gen = run.state["gen"]
    gen.manual_seed(seeds.derive(run.seed, "draws", i))
    d = {}
    if Nc > M:
        d["cond_priority"] = torch.rand((B, Nc), generator=gen, device=dev)
    d["fps_starts"] = torch.stack([
        torch.randint(0, min(Nc, M), (B,), generator=gen, device=dev),
        torch.randint(0, cfg["set_abstractions"][0][0], (B,), generator=gen,
                      device=dev)])
    d["x_init"] = torch.randn((B, N, 3), generator=gen, device=dev)
    if hierarchical(run):
        d["step_priorities"] = torch.rand((steps, B, N), generator=gen,
                                          device=dev)
    return d


def sample_call(run, src: torch.Tensor, ref: torch.Tensor,
                draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sampler call a request makes."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    tr = run.cell.traffic
    return guided_sample_loop(
        run.state["model"], run.state["schedule"], src, ref,
        num_inference_steps=tr["steps"], guidance_scale=tr["guidance"],
        use_hierarchical=hierarchical(run), mesh=run.state.get("mesh"),
        **draws)


def request(run, i: int) -> dict:
    """Request i, timed on the host: the answer is kept for the check."""
    from pointcloud_style_transfer_torch.data.preprocessing import (
        denormalize_point_cloud, normalize_point_cloud)
    a, b = pair_of(run, i)
    t_start = time.perf_counter()
    with record_function("request.normalize"):
        src_n, src_params = normalize_point_cloud(run.state["sims"][a])
        ref_n, _ = normalize_point_cloud(run.state["reals"][b])
    with record_function("request.copy_in"):
        src = torch.from_numpy(src_n)[None].to(run.device)
        ref = torch.from_numpy(ref_n)[None].to(run.device)
    with record_function("request.draws"):
        draws = draws_of(run, i)
    t_call = time.perf_counter()
    with record_function("request.sampler_call"):
        out = sample_call(run, src, ref, draws)
    t_return = time.perf_counter()
    with record_function("request.copy_out"):
        res = denormalize_point_cloud(out[0].cpu().numpy(), src_params)
    run.state["last_out"] = out
    t_end = time.perf_counter()
    run.state["answers"][i] = res.astype(np.float32)
    return {"id": i, "t_start": t_start, "t_call": t_call,
            "t_return": t_return, "t_end": t_end,
            "units": run.cell.traffic["batch"]}


def build(run) -> None:
    """The program, its weights and the traffic pool; no warm-up."""
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, make_schedule)
    cfg, tr = run.cell.config, run.cell.traffic
    config = port_config(cfg)
    run.state["weights"] = weights.make(cfg, run.seed, run.device)
    mark(run, "weights")
    model = PointCloudDiffusionModel(config, run.device)
    load_net(model, run.state["weights"])
    mark(run, "model")
    run.state.update(model=model, answers={},
                     schedule=make_schedule(config).to(run.device),
                     gen=torch.Generator(device=run.device))
    run.state["sims"], run.state["reals"] = lidar_pairs.pool(
        lambda p: seeds.derive(run.seed, "pair", p), tr["pool_pairs"],
        cfg["total_points"])
    mark(run, "pool")


def setup(run) -> None:
    build(run)
    # the sampler's one graph key: its first call runs eagerly, its
    # second captures the graph that every later request replays
    for i in (-1, -2):
        request(run, i)
        mark(run, f"warm-up {-i}")
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" else None


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


def print_segments(records: List[dict], t0: float, width: float = 5.0
                   ) -> None:
    """The window's rate in stretches of ``width`` seconds, on standard
    error: drift inside a window shows there."""
    counts: Dict[int, int] = {}
    for r in records:
        k = int((r["t_end"] - t0) // width)
        counts[k] = counts.get(k, 0) + r["units"]
    print("window rate by %gs: " % width + " ".join(
        "%.3f" % (counts[k] / width) for k in sorted(counts)),
        file=sys.stderr)


def trace_stretch(run):
    n = run.cell.traffic["trace_requests"]

    def stretch() -> int:
        for _ in range(n):
            request(run, run.state["next_id"])
            run.state["next_id"] += 1
        return n
    return stretch


def trace(run) -> None:
    run.trace_summary = tracing.profile(trace_stretch(run), run.device)


def release(run) -> None:
    """The program's graphs and tensors go before the reference runs."""
    from pointcloud_style_transfer_torch.models import capture
    capture.release()
    for key in ("model", "schedule", "last_out"):
        run.state.pop(key, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def checked_ids(run) -> List[int]:
    """The finished requests the check compares, drawn from the seed."""
    done = [r["id"] for r in run.records]
    k = min(run.cell.check["requests"], len(done))
    rng = seeds.numpy_rng(run.seed, "check")
    return sorted(int(i) for i in rng.choice(done, k, replace=False))


def reference_answer(run, i: int, precision: str = "fp32") -> tuple:
    """(the reference's answer to request i in its source's normalised
    frame, that frame's (centre, scale))."""
    cfg, tr = run.cell.config, run.cell.traffic
    a, b = pair_of(run, i)
    src_n, params = ref_request.normalize(run.state["sims"][a],
                                          cfg["target_range"])
    ref_n, _ = ref_request.normalize(run.state["reals"][b],
                                     cfg["target_range"])
    d = {k: v[:, 0] if k in ("step_priorities", "fps_starts") else v[0]
         for k, v in draws_of(run, i).items()}
    out = ref_sampler.guided_transfer(
        run.state["weights"], cfg, torch.from_numpy(src_n).to(run.device),
        torch.from_numpy(ref_n).to(run.device), d, tr["steps"],
        tr["guidance"], hierarchical(run), precision)
    return out.cpu().numpy(), params


def answers_of(run, i: int) -> List[np.ndarray]:
    """Every answer the program gave to request i (one a rank)."""
    return [run.state["answers"][i]]


def check(run, answers=answers_of) -> List[dict]:
    """The compared numbers: every answer ``answers(run, i)`` gives to each
    checked request against the reference's (``core.compare``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = checked_pairs(run, answers)["program"]
    return compare.numbers(compare.serve_readings(pairs),
                           run.cell.check["limits"])


def reference_pair(run, i: int) -> tuple:
    """(the float32 reference's answer to request i, the bfloat16 floor's,
    the source's (centre, scale))."""
    ref, params = reference_answer(run, i)
    return ref, reference_answer(run, i, "bf16")[0], params


def checked_pairs(run, answers=answers_of, controls=()) -> dict:
    """(point distances from the float32 reference, the bfloat16 floor's)
    for each answer to each checked request: under ``"program"`` the
    program's, and under each precision of ``controls`` the reference's
    own at that precision in the program's place. The references are
    ``run.state["references"]``'s where a driver worked them out already."""
    out = {name: [] for name in ("program", *controls)}
    done = run.state.get("references", {})
    for i in checked_ids(run):
        ref, floor, params = done[i] if i in done else reference_pair(run, i)
        e_floor = compare.point_errors(floor, ref)
        for a in answers(run, i):
            out["program"].append((compare.point_errors(
                ref_request.to_normalized(a, params), ref), e_floor))
        for p in controls:
            out[p].append((compare.point_errors(
                reference_answer(run, i, p)[0], ref), e_floor))
    return out
