"""Per-step grid unsafe rows along a real sampling trajectory on the
PyTorch port: the counterpart of ``examples/probe_sampler_unsafe.py``.

``guided_sample_loop``'s hierarchical body (``models/samplers.py``) runs
one step at a time, its upsample through the kd-grid with the probe's grid
(by default the JAX probe's (16,16,8) cells, z halo 2, slot window 256,
tq 128), and each step reports the rows the grid could not prove exact:
the count the fallback ladder patches (``ops/grid_knn.py``), which decides
its tier and so the grid's cost in the sampler. Synthetic probes (pure
noise, clean surfaces) bracket it; the mid-trajectory mixture is what the
sampler pays for. The counts are read through
``grid_knn.recording_unsafe``, once a step on the host, so the loop runs
eagerly by design, as ``selections=`` runs do. Unlike the JAX probe, which
interpolated from the grid's unpatched answer and printed the median
third-neighbour distances, the trajectory here is the exact one the
sampler takes with this grid.

Usage: python examples/probe_sampler_unsafe_torch.py [steps] [Sx Sy Sz]
           [z_halo] [slot_cap] [--device cuda|cpu]
           [--config FIELD=VALUE ...]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    make_schedule, samplers)
from pointcloud_style_transfer_torch.models.diffusion import \
    ddim_step  # noqa: E402
from pointcloud_style_transfer_torch.ops import (  # noqa: E402
    grid_knn, voxel_downsample, voxel_downsample_partition)
from pointcloud_style_transfer_torch.ops.voxel import voxel_order  # noqa: E402

TQ = 128
CAPS = (4096, 8192, 16384, 32768, 65536)


def draws(model, steps: int, generator: torch.Generator) -> dict:
    """The trajectory's draws from ``generator``: source and condition
    clouds (normal x 0.9), the condition's voxel priorities, the FPS
    starts, the initial noise and each step's voxel priorities."""
    cfg, dev = model.config, model.device
    N, M = cfg.total_points, cfg.global_points

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    src, cond = randn(1, N, 3) * 0.9, randn(1, N, 3) * 0.9
    return {"source": src, "condition": cond,
            "cond_priority": torch.rand((1, N), generator=generator,
                                        device=dev),
            "fps_starts": model.net.style_encoder.encoder.draw_fps_starts(
                M, 1, generator, dev),
            "x_init": randn(1, N, 3),
            "step_priorities": torch.rand((steps, 1, N), generator=generator,
                                          device=dev)}


def trajectory(model, schedule, d: dict, steps: int, grid: dict,
               on_step: Optional[Callable] = None) -> list[int]:
    """The hierarchical loop on the draws ``d`` with the grid's keywords
    ``grid``: the unsafe rows of each step's grid pass, read on the host.
    ``on_step(s, query, ref)`` sees each step's unknown points and coarse
    points (one cloud each) before the pass."""
    cfg = model.config
    M = cfg.global_points
    cond_ds, _ = voxel_downsample(d["condition"], M,
                                  priority=d["cond_priority"])
    style = model.encode_style(cond_ds, d["fps_starts"])
    style_in = torch.cat([style, torch.zeros_like(style)])
    ts, t_prev = samplers._step_schedule(schedule.num_timesteps, steps)
    x, counts = d["x_init"], []
    bound = functools.partial(grid_knn.grid_knn_interpolate_layout, **grid)
    with common.patched(grid_knn, "grid_knn_interpolate_layout", bound):
        for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
            order = voxel_order(x, M, priority=d["step_priorities"][s])
            x_coarse, x_idx, unknown, unk_xyz = voxel_downsample_partition(
                x, M, order=order)
            t_in = torch.full((2,), t, dtype=torch.int64, device=x.device)
            nc = model.predict_noise(torch.cat([x_coarse, x_coarse]), t_in,
                                     style_in)
            nc_cond, nc_unc = nc.float().chunk(2)
            guided = nc_unc + cfg.guidance_scale * (nc_cond - nc_unc)
            if on_step is not None:
                on_step(s, unk_xyz[0], x_coarse[0])
            with grid_knn.recording_unsafe() as passes:
                noise = samplers._upsample_unknown(
                    x, x_idx, guided, "grid", unknown=unknown,
                    ref_xyz=x_coarse, unknown_xyz=unk_xyz)
            # no pass where the refs are too few for the grid (brute force)
            counts.append(int(torch.stack(passes).sum()) if passes else 0)
            x = ddim_step(schedule, x, noise, t, tp,
                          source_points=d["source"],
                          content_anchor=cfg.content_anchor,
                          target_range=cfg.target_range)
    if not torch.isfinite(x).all():
        raise RuntimeError("the trajectory's last state is not finite")
    return counts


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*", type=int,
                        help="[steps] [Sx Sy Sz] [z_halo] [slot_cap]")
    common.script_args(parser)
    args = parser.parse_args(argv)
    a = args.args
    steps = a[0] if a else 50
    gs = tuple(a[1:4]) if len(a) >= 4 else (16, 16, 8)
    halo = a[4] if len(a) >= 5 else 2
    slot_cap = a[5] if len(a) >= 6 else 256
    grid = {"grid_shape": gs, "tq": TQ, "slot_cap": slot_cap,
            "z_halo": halo}
    model = common.random_model(args.device, common.config_of(args))
    schedule = make_schedule(model.config).to(model.device)
    gen = torch.Generator(device=model.device).manual_seed(common.SEED + 3)
    ts, _ = samplers._step_schedule(schedule.num_timesteps, steps)
    counts = trajectory(model, schedule, draws(model, steps, gen), steps,
                        grid)
    for s, n in enumerate(counts):
        print(f"step {s:3d} t={int(ts[s]):4d} unsafe={n}", flush=True)
    c = np.array(counts)
    n_query = model.config.total_points - model.config.global_points
    print(f"\ngrid={gs} z_halo={halo} slot_cap={slot_cap} "
          f"({common.device_name(model.device)}, {n_query} queries a step)"
          f"  min={c.min()} median={int(np.median(c))} mean={c.mean():.0f} "
          f"max={c.max()}")
    over = {cap: int((c > cap).sum()) for cap in CAPS}
    for cap, n in over.items():
        print(f"  steps over {cap}: {n}/{steps}")
    return {"device": common.device_name(model.device), "grid": grid,
            "steps": steps, "t": [int(t) for t in ts], "unsafe": counts,
            "steps_over": over}


if __name__ == "__main__":
    main()
