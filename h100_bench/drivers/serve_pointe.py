"""Serving with Point-E's transformer as the denoiser: ``drivers/serve.py``'s
closed loop (its request path, draws, window and trace stretch), on a
model built with the configuration's ``denoiser`` spec and loaded with
``core/point_e_spec.py``'s weights, strict.

The check compares the timed path's answers as ``serve.py``'s does, but
against ``reference/point_e.py::pinned_transfer`` (``reference/
sampler.py``'s loop with ``PointENet`` as the network) following the
program's own discrete choices: with full attention over the voxel
downsample, a representative that flips on rounding changes a token every
point attends to, so the unpinned sampler runs part at once at any
precision (its floor, the bfloat16 reference's distance from the float32
one, is a third of the cloud's radius) and no fault can be told from a
sound run. Before the program is released, each checked request runs once
more through ``guided_sample_loop(selections=...)`` (eagerly, recording
each step's voxel order and upsample neighbours; the timed graph is the
eager body captured, so it takes the same choices); the references, the
float32 one and the bfloat16 floor, then follow those choices, and the
timed answer is compared with them (a timed path whose choices differed
parts from them as the unpinned sampler does). The recorded choices are
themselves held to the reference's rules (``reference/point_e.py::
choice_misses``) step by step on the points the program took them on:
``voxel_miss_pct``, the share of recorded representatives the voxel rule
does not choose, and ``knn_miss_pct``, the share of recorded neighbours
past the float32 third-nearest, the worst request's. (On the float32
reference's own points, which drift from the program's by rounding, a
sound run misses 29-34% of the representatives and 18-27% of the
neighbours, and no fault would show.) Those points are the program's, and
are held to the reference through the answer that follows from them. This
module carries its own ``reference_answer`` and the functions that call it.

A traced run also records the program's spans (``core/program_spans.py``'s
two stretches, through this driver's requests) into
``run.state["program_spans"]``, where every span reader finds them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core import compare, point_e_spec, program_spans, seeds
from ..core.harness import mark
from ..core.span_log import span_log
from ..reference import point_e as ref_point_e
from ..reference import request as ref_request
from ..traffic import lidar_pairs
from . import serve
from .serve import (answers_of, checked_ids, draws_of,  # noqa: F401
                    hierarchical, load_net, pair_of, port_config, request,
                    window)


def denoiser(cfg: dict):
    """The port's spec of the configuration's ``denoiser`` entry."""
    from pointcloud_style_transfer_torch.models.transformer import (
        denoiser_spec)
    d = {k: v for k, v in cfg["denoiser"].items()}
    d["style_width"] = cfg["feature_dim"]
    return denoiser_spec(d)


def build(run) -> None:
    """The program with the transformer, its weights and the traffic pool;
    no warm-up."""
    from pointcloud_style_transfer_torch.models import (
        PointCloudDiffusionModel, make_schedule)
    cfg, tr = run.cell.config, run.cell.traffic
    config = port_config(cfg)
    spec = denoiser(cfg)
    run.state["weights"] = point_e_spec.make(cfg, run.seed, run.device)
    mark(run, "weights")
    model = PointCloudDiffusionModel(config, run.device, denoiser=spec)
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
    for i in (-1, -2):  # the sampler's key: eager, then captured
        request(run, i)
        mark(run, f"warm-up {-i}")
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def trace(run) -> None:
    serve.trace(run)
    run.state[program_spans.KEY] = span_log(run, request)


def normalized_inputs(run, i: int) -> tuple:
    """Request i's (source, reference) in their normalised frames, as the
    reference normalises them, and the source's (centre, scale)."""
    cfg = run.cell.config
    a, b = pair_of(run, i)
    src_n, params = ref_request.normalize(run.state["sims"][a],
                                          cfg["target_range"])
    ref_n, _ = ref_request.normalize(run.state["reals"][b],
                                     cfg["target_range"])
    return src_n, ref_n, params


def record_choices(run) -> None:
    """Each checked request's discrete choices, from the program run once
    more with ``selections`` (eager): ``run.state["choices"][i]`` =
    (voxel orders [steps, N], neighbours [steps, N - M, 3], the points
    each step's choices were taken on [steps, N, 3], the recorded answer in
    the normalised frame)."""
    from pointcloud_style_transfer_torch.models import guided_sample_loop
    tr = run.cell.traffic
    if not hierarchical(run):
        raise ValueError("the pinned check follows the hierarchical branch")
    run.state["choices"] = {}
    for i in checked_ids(run):
        src_n, ref_n, _ = normalized_inputs(run, i)
        sel: dict = {}
        out = guided_sample_loop(
            run.state["model"], run.state["schedule"],
            torch.from_numpy(src_n)[None].to(run.device),
            torch.from_numpy(ref_n)[None].to(run.device),
            num_inference_steps=tr["steps"], guidance_scale=tr["guidance"],
            use_hierarchical=hierarchical(run), selections=sel,
            **draws_of(run, i))
        steps = range(tr["steps"])
        run.state["choices"][i] = tuple(
            torch.stack([sel[f"step{s}.{key}"][0] for s in steps])
            for key in ("voxel", "knn", "voxel.points")) + (
            out[0].float().cpu().numpy(),)


def release(run) -> None:
    """The checked requests' choices recorded, then ``serve.release``."""
    record_choices(run)
    serve.release(run)


def request_draws(run, i: int) -> dict:
    """Request i's draws in the reference's shapes (one cloud)."""
    return {k: v[:, 0] if k in ("step_priorities", "fps_starts") else v[0]
            for k, v in draws_of(run, i).items()}


def reference_answer(run, i: int, precision: str = "fp32") -> tuple:
    """(the reference's answer to request i, following the program's
    recorded choices, in its source's normalised frame; that frame's
    (centre, scale))."""
    cfg, tr = run.cell.config, run.cell.traffic
    src_n, ref_n, params = normalized_inputs(run, i)
    orders, neighbours = run.state["choices"][i][:2]
    net = ref_point_e.PointENet(run.state["weights"], cfg, precision)
    out = ref_point_e.pinned_transfer(
        net, cfg, torch.from_numpy(src_n).to(run.device),
        torch.from_numpy(ref_n).to(run.device), request_draws(run, i),
        tr["steps"], tr["guidance"], orders, neighbours)
    return out.cpu().numpy(), params


def choice_readings(run, i: int) -> Dict[str, float]:
    """Request i's recorded choices held to the reference's rules on the
    recorded points: the shares (%) of representatives (M a step) and of
    neighbours (3 a point interpolated) that miss, over every step."""
    M = int(run.cell.config["global_points"])
    orders, neighbours, points = run.state["choices"][i][:3]
    prio = request_draws(run, i)["step_priorities"]
    misses = [ref_point_e.choice_misses(points[s], prio[s], M, orders[s],
                                        neighbours[s])
              for s in range(orders.shape[0])]
    voxel, knn = (sum(m[j] for m in misses) for j in (0, 1))
    steps = len(misses)
    return {"voxel_miss_pct": 100.0 * voxel / (steps * M),
            "knn_miss_pct": 100.0 * knn / (steps * neighbours[0].numel())}


def reference_pair(run, i: int) -> tuple:
    """(the float32 reference's answer to request i, the bfloat16 floor's,
    the source's (centre, scale))."""
    ref, params = reference_answer(run, i)
    return ref, reference_answer(run, i, "bf16")[0], params


def checked_pairs(run, answers=answers_of, controls=()) -> dict:
    """``serve.checked_pairs`` with this module's reference; the distance
    of each timed answer from the recorded run's is printed."""
    import sys
    out = {name: [] for name in ("program", *controls)}
    for i in checked_ids(run):
        ref, floor, params = reference_pair(run, i)
        e_floor = compare.point_errors(floor, ref)
        recorded = run.state["choices"][i][3]
        for a in answers(run, i):
            a = ref_request.to_normalized(a, params)
            out["program"].append((compare.point_errors(a, ref), e_floor))
            print(f"reading timed_vs_recorded_max = "
                  f"{float(compare.point_errors(a, recorded).max())!r}",
                  file=sys.stderr)
        for p in controls:
            out[p].append((compare.point_errors(
                reference_answer(run, i, p)[0], ref), e_floor))
    return out


def check(run, answers=answers_of) -> List[dict]:
    """The compared numbers (``serve.check``'s, against the pinned
    references)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = checked_pairs(run, answers)["program"]
    readings = compare.serve_readings(pairs)
    per = [choice_readings(run, i) for i in checked_ids(run)]
    readings.update({k: max(r[k] for r in per) for k in per[0]})
    return compare.numbers(readings, run.cell.check["limits"])
