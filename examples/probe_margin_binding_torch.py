"""Which margin term makes the kd-grid's unsafe rows unsafe, along a real
sampling trajectory on the PyTorch port: the counterpart of
``examples/probe_margin_binding.py``.

The exactness margin of a grid row (``ops/grid_knn.py::_safe_rows``) is the
least of three squared budgets: the +-H x-slab strip (``msq_x``), the
covered slabs' y bands (``msq_slab``) and, with windowed z-runs, the
(slab, row) pairs' z-runs (``msq_pair``; infinite with whole columns). For
each unsafe row that neither lacks k candidates (``sentinel``) nor lies in
a tile whose runs overflow their window (``window``), the probe names the
term that binds, and for each term a rescue bound: the unsafe rows whose
k-th distance fits the least of the other two terms, i.e. what an
unbounded widening in that one direction could save.

The JAX probe's step body on the unsafe probe's draws
(``probe_sampler_unsafe_torch.draws``), run eagerly a step at a time: the
voxel downsample, the denoiser on the cond/uncond pair and the guidance, the
grid's ``_build_struct`` + ``_query_pass(..., diag=True)`` on the unknown
points against the coarse ones, the probe's own inverse-distance values
from the grid's (unpatched) answer, the scatter assembly and
``ddim_step``. Each step prints the nine counts (read on the host once a
step), then their totals and means.

Usage: python examples/probe_margin_binding_torch.py [steps]
           [--device cuda|cpu] [--config FIELD=VALUE ...]
Env knobs: PCST_PROF_GRID, PCST_PROF_SLOT_CAP (and the others of
``profile_common_torch.grid_knobs``; the fallback cap is not read).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import probe_sampler_unsafe_torch as unsafe_probe  # noqa: E402
import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    make_schedule, samplers)
from pointcloud_style_transfer_torch.models.diffusion import \
    ddim_step  # noqa: E402
from pointcloud_style_transfer_torch.ops import (  # noqa: E402
    complement_indices, grid_knn, index_points, voxel_downsample)

NAMES = ("unsafe", "sentinel", "window", "binds_x", "binds_slab",
         "binds_pair", "rescue_x", "rescue_slab", "rescue_pair")


def binding_counts(unsafe: torch.Tensor, diag: dict) -> torch.Tensor:
    """The nine counts (``NAMES``) of one pass from its unsafe flags and
    its margin terms (``_query_pass(diag=True)``), as the JAX probe
    computes them."""
    dk = diag["d_last"]
    sentinel = dk >= 1e29
    window = ~diag["tile_ok"]
    margin_only = unsafe & ~sentinel & ~window
    mx, ms, mp = diag["msq_x"], diag["msq_slab"], diag["msq_pair"]
    binds_x = margin_only & (mx <= ms) & (mx <= mp)
    binds_s = margin_only & ~binds_x & (ms <= mp)
    binds_p = margin_only & ~binds_x & ~binds_s
    resc_x = margin_only & (dk <= torch.minimum(ms, mp))
    resc_s = margin_only & (dk <= torch.minimum(mx, mp))
    # the pair rescue is also the whole-column rescue bound: whole columns
    # make the pair budget infinite
    resc_p = margin_only & (dk <= torch.minimum(mx, ms))
    return torch.stack([m.sum() for m in (
        unsafe, sentinel, window & ~sentinel, binds_x, binds_s, binds_p,
        resc_x, resc_s, resc_p)])


def trajectory(model, schedule, d: dict, steps: int, knobs: dict,
               on_step: Optional[Callable] = None) -> list[list[int]]:
    """The probe's loop on the draws ``d`` with the grid's keywords
    ``knobs``: each step's nine counts, read on the host. ``on_step(s,
    query, ref)`` sees each step's unknown and coarse points (one cloud
    each) before the pass."""
    cfg = model.config
    N, M = cfg.total_points, cfg.global_points
    gs = tuple(knobs["grid_shape"])
    cond_ds, _ = voxel_downsample(d["condition"], M,
                                  priority=d["cond_priority"])
    style = model.encode_style(cond_ds, d["fps_starts"])
    style_in = torch.cat([style, torch.zeros_like(style)])
    ts, t_prev = samplers._step_schedule(schedule.num_timesteps, steps)
    x, counts = d["x_init"], []
    for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
        t_in = torch.full((2,), t, dtype=torch.int64, device=x.device)
        x_coarse, x_idx = voxel_downsample(x, M,
                                           priority=d["step_priorities"][s])
        nc = model.predict_noise(torch.cat([x_coarse, x_coarse]), t_in,
                                 style_in)
        nc_c, nc_u = nc.float().chunk(2)
        guided = nc_u + cfg.guidance_scale * (nc_c - nc_u)
        unknown = complement_indices(x_idx, N)
        q = index_points(x, unknown)[0]
        r = index_points(x, x_idx)[0]
        if on_step is not None:
            on_step(s, q, r)
        struct = grid_knn._build_struct(r.float(), gs)
        dist2, nbr, unsafe, diag = grid_knn._query_pass(
            struct, q, 3, gs, knobs["tq"], knobs["slot_cap"],
            knobs["z_halo"], knobs["xy_halo"], diag=True)
        counts.append(binding_counts(unsafe, diag).tolist())
        # the grid's own answer, exact or not: a representative trajectory
        w = 1.0 / (torch.sqrt(dist2.clamp(min=0.0)) + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        vals = (guided[0][nbr.long()] * w[..., None]).sum(1)
        noise = torch.zeros((1, N, 3), device=x.device)
        noise[0, unknown[0]] = vals
        noise[0, x_idx[0].long().clamp(0, N - 1)] = guided[0]
        x = ddim_step(schedule, x, noise, t, tp, source_points=d["source"],
                      content_anchor=cfg.content_anchor,
                      target_range=cfg.target_range)
    if not torch.isfinite(x).all():
        raise RuntimeError("the trajectory's last state is not finite")
    return counts


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("steps", nargs="?", type=int, default=50)
    common.script_args(parser)
    args = parser.parse_args(argv)
    knobs = common.grid_knobs()
    model = common.random_model(args.device, common.config_of(args))
    schedule = make_schedule(model.config).to(model.device)
    gen = torch.Generator(device=model.device).manual_seed(common.SEED + 3)
    ts, _ = samplers._step_schedule(schedule.num_timesteps, args.steps)
    counts = trajectory(model, schedule,
                        unsafe_probe.draws(model, args.steps, gen),
                        args.steps, knobs)
    for s, st in enumerate(counts):
        print(f"step {s:3d} t={int(ts[s]):4d} "
              + " ".join(f"{n}={v}" for n, v in zip(NAMES, st)), flush=True)
    a = np.array(counts, dtype=np.int64).reshape(-1, len(NAMES))
    n_query = model.config.total_points - model.config.global_points
    print(f"\ngrid={knobs['grid_shape']} z_halo={knobs['z_halo']} "
          f"slot_cap={knobs['slot_cap']} steps={args.steps} "
          f"({common.device_name(model.device)}, {n_query} queries a step)"
          f"  (totals / per-step mean)")
    totals = {n: int(a[:, j].sum()) for j, n in enumerate(NAMES)}
    means = {n: float(a[:, j].mean()) for j, n in enumerate(NAMES)}
    for n in NAMES:
        print(f"  {n:12s} total={totals[n]:8d}  mean={means[n]:8.0f}")
    return {"device": common.device_name(model.device), "knobs": knobs,
            "steps": args.steps, "t": [int(t) for t in ts],
            "counts": [dict(zip(NAMES, st)) for st in counts],
            "totals": totals, "means": means}


if __name__ == "__main__":
    main()
