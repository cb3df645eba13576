"""The point-sharded sampler held to the single-device one on the card(s):
the counterpart of ``examples/verify_sharded_tpu.py``.

The CPU tests (``tests/test_torch_sharded_sampler.py``) prove the sharding
arithmetic on gloo with the grid's plain twins; here the grid's kernels run
inside the point-sharded loop on the card(s). A pointwise trajectory match
is not attainable for the same reasons as on the TPU (bf16 denoiser, the
voxel downsample's discontinuity, the DDIM step's amplification), so two
gates, on a ``{points: n}`` mesh over every rank of the process group:

  1. assembly: the sharded loop's per-step noise-field assembly (this
     rank's slice of the unknown queries -> ``grid_knn_interpolate`` ->
     the mesh's all-gather -> ``_unpermute_assemble``) equals the
     single-device ``models/samplers.py::_upsample_unknown`` on the same
     ``voxel_downsample_partition`` step inputs, <= 1e-4;
  2. trajectory: Chamfer-L2(``guided_sample_loop_sharded``,
     ``guided_sample_loop``) over ``steps`` steps <= max(3 x floor, 1e-4),
     the floor being the Chamfer between single-device runs from
     ``x_init`` and ``x_init * (1 + 1e-6)``. The sharded loop gets no
     ``knn_backend``: the default must resolve to the grid
     (``resolve_sampler_knn_backend``), which is asserted.

It uses the process group already initialised, else starts one from
``torch.distributed.run``'s environment (``parallel.make_mesh``; a group of
this one process without it). Every rank passes the same draws, from a
generator seeded 11. ``main`` returns each gate's figures and ``ok``; the
script exits 1 when a gate failed.

Usage: python examples/verify_sharded_torch.py [N] [steps]
           [--device cuda|cpu] [--config FIELD=VALUE ...]
       python -m torch.distributed.run --standalone --nproc_per_node 4
           examples/verify_sharded_torch.py
Env knobs: the grid's (``profile_common_torch.grid_knobs``), bound to its
entry points.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    capture, guided_sample_loop, make_schedule, samplers)
from pointcloud_style_transfer_torch.ops import (  # noqa: E402
    chamfer_distance_l2, grid_knn, voxel_downsample,
    voxel_downsample_partition)
from pointcloud_style_transfer_torch.parallel import (  # noqa: E402
    guided_sample_loop_sharded, make_mesh)
from pointcloud_style_transfer_torch.parallel.mesh import \
    POINTS_AXIS  # noqa: E402
from pointcloud_style_transfer_torch.parallel.sharded_sampler import \
    RowSplit  # noqa: E402

ASSEMBLY_BAR = 1e-4
GUIDANCE = 7.5


def world_size() -> int:
    import torch.distributed as dist
    return (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", "1")))


def draws(model, n: int, steps: int, dev: torch.device) -> dict:
    """Source and condition clouds (normal x 0.9) and the sampler's draws
    in its own order, from a generator seeded 11 (the same on every
    rank)."""
    cfg = model.config
    g = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    src, cond = randn(1, n, 3) * 0.9, randn(1, n, 3) * 0.9
    return {"source": src, "condition": cond,
            "cond_priority": torch.rand((1, n), generator=g, device=dev),
            "fps_starts": model.net.style_encoder.encoder.draw_fps_starts(
                cfg.global_points, 1, g, dev),
            "x_init": randn(1, n, 3),
            "step_priorities": torch.rand((steps, 1, n), generator=g,
                                          device=dev)}


def step_inputs(model, schedule, d: dict, steps: int) -> dict:
    """The first step's assembly inputs, as the loop makes them: the
    partition of ``x_init`` and the guided coarse noise."""
    cfg = model.config
    M = cfg.global_points
    cond_ds, _ = voxel_downsample(d["condition"], M,
                                  priority=d["cond_priority"])
    style = model.encode_style(cond_ds, d["fps_starts"])
    style_in = torch.cat([style, torch.zeros_like(style)])
    ts, _ = samplers._step_schedule(schedule.num_timesteps, steps)
    x0 = d["x_init"]
    x_coarse, x_idx, x_unk, x_unk_xyz = voxel_downsample_partition(
        x0, M, priority=d["step_priorities"][0])
    t_in = torch.full((2,), int(ts[0]), dtype=torch.int64, device=x0.device)
    nc = model.predict_noise(torch.cat([x_coarse, x_coarse]), t_in, style_in)
    nc_c, nc_u = nc.float().chunk(2)
    return {"x0": x0, "x_coarse": x_coarse, "x_idx": x_idx, "x_unk": x_unk,
            "x_unk_xyz": x_unk_xyz,
            "guided": nc_u + GUIDANCE * (nc_c - nc_u)}


def sharded_assembly(s: dict, split: RowSplit, n: int) -> torch.Tensor:
    """The sharded loop's per-step assembly (``parallel/sharded_sampler.py``
    through ``samplers._upsample_unknown(split=)``): this rank's slice of
    the unknown queries, the grid interpolation, the all-gather, the
    inverse permutation."""
    vals = grid_knn.grid_knn_interpolate(split.local(s["x_unk_xyz"]),
                                         s["x_coarse"], s["guided"], 3)
    return samplers._unpermute_assemble(s["x_idx"], s["x_unk"], s["guided"],
                                        split.gather(vals), n)


def single_assembly(s: dict) -> torch.Tensor:
    """The single-device loop's assembly, ``_upsample_unknown`` on the
    grid."""
    return samplers._upsample_unknown(
        s["x0"], s["x_idx"], s["guided"], "grid", unknown=s["x_unk"],
        ref_xyz=s["x_coarse"], unknown_xyz=s["x_unk_xyz"])


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*", type=int, help="[N] [steps]")
    common.script_args(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_mesh({POINTS_AXIS: world_size()}, dev.type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = common.config_of(args)
    n = args.args[0] if args.args else cfg.total_points
    steps = args.args[1] if len(args.args) > 1 else 10
    cfg = cfg.replace(total_points=n)
    model = common.random_model(dev, cfg)
    schedule = make_schedule(cfg).to(dev)
    split = RowSplit(mesh, POINTS_AXIS, dev.type)
    backend = samplers.resolve_sampler_knn_backend(cfg)
    print(f"device={common.device_name(dev)}  ranks={split.n}  mesh="
          f"{{'{POINTS_AXIS}': {split.n}}}  N={n} M={cfg.global_points} "
          f"steps={steps}  default knn_backend={backend}")
    if backend != "grid":
        raise RuntimeError(f"the sampler's default kNN backend resolves to "
                           f"{backend!r}, not the grid")
    with common.grid_bound(common.grid_knobs()):
        d = draws(model, n, steps, dev)
        s = step_inputs(model, schedule, d, steps)
        inside = sharded_assembly(s, split, n)
        fused = single_assembly(s)
        err1 = float((inside - fused).abs().max())
        ok1 = bool(torch.isfinite(inside).all()) and err1 <= ASSEMBLY_BAR
        print(f"[1] sliced + gathered assembly vs single-device fused: max "
              f"diff = {err1}  ({'OK' if ok1 else 'FAILED'})", flush=True)

        run = dict(num_inference_steps=steps, guidance_scale=GUIDANCE,
                   cond_priority=d["cond_priority"],
                   fps_starts=d["fps_starts"],
                   step_priorities=d["step_priorities"])
        src, cond = d["source"], d["condition"]
        out_sh = guided_sample_loop_sharded(model, schedule, src, cond, mesh,
                                            x_init=d["x_init"], **run)
        finite = bool(torch.isfinite(out_sh).all())
        print(f"sharded (default backend) sampler ran: "
              f"{tuple(out_sh.shape)} finite: {finite}")
        out_1d = guided_sample_loop(model, schedule, src, cond,
                                    x_init=d["x_init"], **run)
        wig = guided_sample_loop(model, schedule, src, cond,
                                 x_init=d["x_init"] * (1.0 + 1e-6), **run)
        cd = float(chamfer_distance_l2(out_sh, out_1d)[0])
        floor = float(chamfer_distance_l2(out_1d, wig)[0])
    bar = max(3.0 * floor, 1e-4)
    ok2 = finite and cd <= bar
    print(f"[2] trajectory CD(sharded, single) = {cd:.6g}, chaos floor "
          f"(single vs 1e-6-perturbed single) = {floor:.6g}  "
          f"({'OK' if ok2 else 'FAILED'})")
    ok = ok1 and ok2
    print("POINT-SHARDED x GRID KERNELS (card):" if dev.type == "cuda"
          else "POINT-SHARDED x GRID (cpu):", "OK" if ok else "FAILED")
    return {"device": common.device_name(dev), "ranks": split.n, "n": n,
            "steps": steps, "default_backend": backend,
            "gate1": {"max_diff": err1, "bar": ASSEMBLY_BAR, "ok": ok1},
            "gate2": {"chamfer": cd, "floor": floor, "bar": bar,
                      "finite": finite, "ok": ok2},
            "ok": ok, "step_inputs": s, "fused": fused, "sharded": out_sh}


if __name__ == "__main__":
    import torch.distributed as dist
    ok = main()["ok"]
    capture.release()  # before the group goes (a graph holds its comms)
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)
