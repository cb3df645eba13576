"""DDIM samplers (counterpart of
``pointcloud_style_transfer_tpu/models/samplers.py``).

``guided_sample_loop``, the CFG style transfer: the style is encoded once
from the voxel-downsampled condition cloud; each of the
``num_inference_steps`` steps then runs the denoiser on the cond/uncond
batch, combines with the guidance scale, and takes a DDIM step with the
content anchor and the tanh constraint. When the cloud is larger than
``global_points`` (hierarchical branch) the denoiser sees a voxel
downsample of the current state, the CFG combine runs at coarse resolution,
and the unselected points get the inverse-distance (k=3) interpolation of the
coarse noise: with ``knn_backend="auto"`` or ``"grid"`` through the kd-grid
(``ops/grid_knn.py``, the slot-run interpolation kernel with the brute-force
kernel as its exact fallback), as on the TPU; with ``"pallas"``,
``"pallas_f32packed"`` or ``"pallas_pruned"`` through that brute-force or
pruned kNN kernel alone. Its random draws, in the order they are taken from
``generator`` when not passed in: the condition cloud's voxel priorities, the
two FPS start indices, the initial noise, then each step's voxel priorities.
Its discrete choices that follow the trajectory, each step's voxel order and
the upsample's neighbours, can be recorded into and replayed from a dict
(``selections``), so that a run on one device can follow another's choices
at near-ties (the rest depend on the inputs alone).

``guided_sample_loop_coarse``, the fast mode: the whole trajectory runs on a
voxel downsample of the source and one kNN interpolation upsamples the final
displacement. ``ddim_sample_loop``: plain DDIM without guidance or anchor,
the style re-encoded every step through the model's full forward.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops import (complement_indices, grid_knn, index_points, knn,
                   voxel_downsample, voxel_downsample_partition)
from ..ops.interpolate import apply_interpolation, knn_interpolate_weights
from ..ops.kernels.knn_packed import selected_sq_dist
from ..ops.voxel import voxel_order
from .diffusion import DiffusionSchedule, ddim_step, ddim_timesteps
from .model import PointCloudDiffusionModel


KNN_BACKENDS = ("grid", "jnp", "pallas", "pallas_f32packed", "pallas_pruned")


def resolve_sampler_knn_backend(cfg: Config) -> str:
    """The upsampling kNN's backend, one of ``KNN_BACKENDS``: ``"jnp"`` (the
    brute-force plain version) when ``use_pallas=False``; else what the
    config pins; else, for ``"auto"``, the validated
    ``PCST_SAMPLER_KNN_BACKEND`` environment hook (an experiment switch, read
    only when the config pins nothing) or ``"grid"``, the kd-grid, as on
    the TPU."""
    if not cfg.use_pallas:
        return "jnp"
    if cfg.knn_backend != "auto":
        if cfg.knn_backend not in KNN_BACKENDS:
            raise ValueError(f"unknown knn_backend: {cfg.knn_backend!r}")
        return cfg.knn_backend
    env = os.environ.get("PCST_SAMPLER_KNN_BACKEND")
    if env:
        if env not in KNN_BACKENDS:
            raise ValueError(f"PCST_SAMPLER_KNN_BACKEND={env!r} is not one "
                             f"of {KNN_BACKENDS}")
        return env
    return "grid"


def _record_points(selections: Optional[dict], key: str,
                   **points: torch.Tensor) -> None:
    """Keep the points a choice is taken on under ``key.<name>``."""
    if selections is not None:
        selections.update({f"{key}.{n}": p.detach() for n, p in points.items()})


def _upsample_unknown(x: torch.Tensor, idx: torch.Tensor,
                      coarse_vals: torch.Tensor, knn_backend: str,
                      unknown: Optional[torch.Tensor] = None,
                      ref_xyz: Optional[torch.Tensor] = None,
                      unknown_xyz: Optional[torch.Tensor] = None,
                      selections: Optional[dict] = None, key: str = "knn",
                      split=None) -> torch.Tensor:
    """Place the exact coarse values at their points and interpolate ONLY the
    remaining (unknown) points from their k=3 nearest coarse points with
    weights 1/(sqrt(d)+1e-8), normalised. Returns [B, N, C].

    ``unknown`` (the complement of ``idx``), ``ref_xyz`` (x at ``idx``) and
    ``unknown_xyz`` (x at ``unknown``) are recomputed when not given. The
    grid backend runs cloud by cloud. ``selections`` (a dict) pins the
    neighbours: replayed from ``selections[key]`` when it holds them (their
    distances recomputed in the kernels' form), else the backend's recorded
    there (the grid's from its kNN path, ``grid_knn``); the points they are
    taken on go under ``key.query`` and ``key.ref`` either way. With
    ``split`` (``parallel.sharded_sampler.RowSplit``) this rank
    interpolates its share of the unknown points and the shares are
    all-gathered."""
    B, N, _ = x.shape
    if unknown is None:
        unknown = complement_indices(idx, N)
    q_unknown = index_points(x, unknown) if unknown_xyz is None else unknown_xyz
    if ref_xyz is None:
        ref_xyz = index_points(x, idx)
    k = min(3, idx.shape[1])
    if unknown.shape[1] == 0:
        empty = coarse_vals.new_zeros((B, 0) + tuple(coarse_vals.shape[2:]))
        return _unpermute_assemble(idx, unknown, coarse_vals, empty, N)
    _record_points(selections, key, query=q_unknown, ref=ref_xyz)
    local = (lambda t: t) if split is None else split.local
    gather = (lambda t: t) if split is None else split.gather
    q = local(q_unknown)
    if selections is not None and key in selections:
        nbr = local(selections[key].to(x.device))
        sq_d = selected_sq_dist(q, index_points(ref_xyz, nbr))
    elif knn_backend == "grid":
        if selections is not None:
            selections[key] = knn(q_unknown, ref_xyz, k, backend="grid")[1]
        vals = torch.stack([_grid_interpolate(q[b], ref_xyz[b],
                                              coarse_vals[b], k)
                            for b in range(B)])
        return _unpermute_assemble(idx, unknown, coarse_vals, gather(vals), N)
    else:
        sq_d, nbr = knn(q, ref_xyz, k, backend=knn_backend)
        if selections is not None:
            selections[key] = gather(nbr)
    dist = torch.sqrt(torch.clamp(sq_d, min=0.0))
    w = 1.0 / (dist + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    vals = torch.sum(index_points(coarse_vals, nbr) * w[..., None], dim=2)
    return _unpermute_assemble(idx, unknown, coarse_vals, gather(vals), N)


def _grid_interpolate(query: torch.Tensor, ref_xyz: torch.Tensor,
                      coarse_vals: torch.Tensor, k: int) -> torch.Tensor:
    """One cloud's interpolation [Nq, C] through the grid, in query order:
    the grid answers in its layout order with a query-id map, and layout
    row j goes to query ``qid[j]`` (padding rows, ``qid == Nq``, to a row
    that is dropped)."""
    v_lay, qid = grid_knn.grid_knn_interpolate_layout(query, ref_xyz,
                                                      coarse_vals, k)
    Nq = query.shape[0]
    out = coarse_vals.new_empty((Nq + 1, coarse_vals.shape[1]))
    return out.index_copy_(0, qid.long(), v_lay.to(coarse_vals.dtype))[:Nq]


def _unpermute_assemble(idx: torch.Tensor, unknown: torch.Tensor,
                        coarse_vals: torch.Tensor, vals: torch.Tensor,
                        N: int) -> torch.Tensor:
    """idx and unknown partition 0..N-1, so [coarse_vals; vals] is the field
    in permuted order: scatter it back to point order (the TPU's
    inverse-permutation sort, done as the scatter it stands for)."""
    perm = torch.cat([idx.long().clamp(0, N - 1), unknown.long()], dim=1)
    vals_all = torch.cat([coarse_vals, vals], dim=1)
    out = torch.empty_like(vals_all)
    return out.scatter_(1, perm[..., None].expand_as(vals_all), vals_all)


def _step_schedule(num_timesteps: int, num_inference_steps: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    ts = ddim_timesteps(num_timesteps, num_inference_steps)
    t_prev = np.concatenate([ts[1:], [-1]])
    # t_prev is -1 (alpha_prev = 1) whenever t == 0
    t_prev = np.where(ts > 0, t_prev, -1)
    return ts, t_prev


@torch.no_grad()
def guided_sample_loop(model: PointCloudDiffusionModel,
                       schedule: DiffusionSchedule,
                       source_points: torch.Tensor,
                       condition_points: torch.Tensor,
                       num_inference_steps: int = 50,
                       guidance_scale: float = 7.5,
                       use_hierarchical: Optional[bool] = None,
                       x_init: Optional[torch.Tensor] = None,
                       cond_priority: Optional[torch.Tensor] = None,
                       step_priorities: Optional[torch.Tensor] = None,
                       fps_starts: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       selections: Optional[dict] = None,
                       knn_backend: Optional[str] = None,
                       mesh=None, axis_name: str = "points"
                       ) -> torch.Tensor:
    """CFG style transfer of ``source_points`` [B, N, 3] toward the style of
    ``condition_points`` [B, Nc, 3], on the model's device. Returns
    [B, N, 3] float32.

    Draws that may be passed in: ``x_init`` [B, N, 3] initial noise,
    ``cond_priority`` [B, Nc] condition-cloud voxel priorities,
    ``step_priorities`` [steps, B, N] per-step voxel priorities,
    ``fps_starts`` [2, B] the encoder's FPS start indices. The rest come
    from ``generator``. The hierarchical branch runs when N > global_points
    unless ``use_hierarchical`` says otherwise. ``selections`` (a dict)
    pins each step s's voxel order (``step<s>.voxel``, taken on the state
    ``step<s>.voxel.points``) and the upsample's neighbours (``step<s>.knn``,
    ``_upsample_unknown``): a choice the dict holds is replayed, any other
    is recorded there; replaying expects the step priorities passed in.
    ``knn_backend`` overrides ``resolve_sampler_knn_backend``.

    With ``mesh``, the ranks of its ``axis_name`` axis share the
    hierarchical branch's upsample (``parallel.sharded_sampler``): each
    interpolates its share of the N - M unknown points, which must divide,
    and, when they divide M, the denoiser runs on its share of the coarse
    rows; the shares are all-gathered. Every rank passes the same inputs
    and draws (or an identically seeded generator) and returns the same
    cloud."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    source_points = source_points.to(device=device, dtype=torch.float32)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    B, N, _ = source_points.shape
    M = cfg.global_points
    if use_hierarchical is None:
        use_hierarchical = N > M
    if knn_backend is None:
        knn_backend = resolve_sampler_knn_backend(cfg)
    split = rows = None
    if mesh is not None:
        from ..parallel.sharded_sampler import RowSplit
        split = RowSplit(mesh, axis_name, device.type)
        if use_hierarchical:
            split.check(N - M, "unknown count N-M")
            rows = split if M % split.n == 0 else None

    cond_ds, _ = voxel_downsample(condition_points, M, priority=cond_priority,
                                  generator=generator)
    style = model.encode_style(cond_ds, fps_starts, generator)
    style_in = torch.cat([style, torch.zeros_like(style)], dim=0)  # [2B, F]

    if x_init is None:
        x = torch.randn(source_points.shape, generator=generator,
                        device=device, dtype=torch.float32)
    else:
        x = x_init.to(device=device, dtype=torch.float32)
    ts, t_prev = _step_schedule(schedule.num_timesteps, num_inference_steps)

    for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
        if use_hierarchical:
            t_in = torch.full((2 * B,), t, dtype=torch.int64, device=device)
            key = f"step{s}.voxel"
            _record_points(selections, key, points=x)
            order = None if selections is None else selections.get(key)
            if order is None:
                order = voxel_order(x, M, priority=None if step_priorities
                                    is None else step_priorities[s],
                                    generator=generator)
                if selections is not None:
                    selections[key] = order
            x_coarse, x_idx, x_unk, x_unk_xyz = voxel_downsample_partition(
                x, M, order=order)
            x2 = torch.cat([x_coarse, x_coarse], dim=0)
            if rows is None:
                noise_coarse = model.predict_noise(x2, t_in, style_in)
            else:
                noise_coarse = rows.gather(model.predict_noise(
                    rows.local(x2), t_in, style_in))
            nc_cond, nc_unc = noise_coarse.float().chunk(2)
            # CFG combine at coarse resolution: interpolation is linear, so
            # combine-then-upsample equals upsample-then-combine
            guided_coarse = nc_unc + guidance_scale * (nc_cond - nc_unc)
            final_noise = _upsample_unknown(x, x_idx, guided_coarse,
                                            knn_backend, unknown=x_unk,
                                            ref_xyz=x_coarse,
                                            unknown_xyz=x_unk_xyz,
                                            selections=selections,
                                            key=f"step{s}.knn", split=split)
        else:
            final_noise = _guided_step(model, x, t, style_in, guidance_scale)

        x = ddim_step(schedule, x, final_noise, t, tp,
                      source_points=source_points,
                      content_anchor=cfg.content_anchor,
                      target_range=cfg.target_range)
    return x


def _guided_step(model: PointCloudDiffusionModel, x: torch.Tensor, t: int,
                 style_in: torch.Tensor, guidance_scale: float
                 ) -> torch.Tensor:
    """The CFG noise of one step at x's own resolution."""
    B = x.shape[0]
    t_in = torch.full((2 * B,), t, dtype=torch.int64, device=x.device)
    pred = model.predict_noise(torch.cat([x, x], dim=0), t_in, style_in)
    nc, nu = pred.float().chunk(2)
    return nu + guidance_scale * (nc - nu)


@torch.no_grad()
def guided_sample_loop_coarse(model: PointCloudDiffusionModel,
                              schedule: DiffusionSchedule,
                              source_points: torch.Tensor,
                              condition_points: torch.Tensor,
                              num_inference_steps: int = 50,
                              guidance_scale: float = 7.5,
                              use_hierarchical: bool = True,
                              x_init: Optional[torch.Tensor] = None,
                              cond_priority: Optional[torch.Tensor] = None,
                              src_priority: Optional[torch.Tensor] = None,
                              fps_starts: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Fast CFG sampling: the whole DDIM trajectory runs at coarse resolution
    (a voxel downsample of the source, the content anchor pulling toward it)
    and the final displacement field is upsampled once: one kNN (k=3) of every
    source point against the coarse points over the static source geometry,
    ``source + interpolated displacement``. Without a hierarchy
    (``use_hierarchical=False`` or N <= global_points) it is the guided loop
    at full resolution. Returns [B, N, 3] float32.

    Draws that may be passed in, else taken from ``generator`` in this order:
    ``cond_priority`` [B, Nc], ``fps_starts`` [2, B], ``src_priority`` [B, N]
    the source's voxel priorities, ``x_init`` [B, Mc, 3] the initial noise at
    coarse resolution."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    source_points = source_points.to(device=device, dtype=torch.float32)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    N = source_points.shape[1]
    M = cfg.global_points

    cond_ds, _ = voxel_downsample(condition_points, M, priority=cond_priority,
                                  generator=generator)
    style = model.encode_style(cond_ds, fps_starts, generator)
    style_in = torch.cat([style, torch.zeros_like(style)], dim=0)

    knn_backend = resolve_sampler_knn_backend(cfg)
    if use_hierarchical and N > M:
        src_coarse, src_idx = voxel_downsample(
            source_points, M, priority=src_priority, generator=generator)
    else:
        src_coarse, src_idx = source_points, None

    if x_init is None:
        x = torch.randn(src_coarse.shape, generator=generator, device=device,
                        dtype=torch.float32)
    else:
        x = x_init.to(device=device, dtype=torch.float32)
    ts, t_prev = _step_schedule(schedule.num_timesteps, num_inference_steps)
    for t, tp in zip(ts.tolist(), t_prev.tolist()):
        final_noise = _guided_step(model, x, t, style_in, guidance_scale)
        x = ddim_step(schedule, x, final_noise, t, tp,
                      source_points=src_coarse,
                      content_anchor=cfg.content_anchor,
                      target_range=cfg.target_range)
    if src_idx is None:
        return x
    disp = x - src_coarse
    nbr, w = knn_interpolate_weights(source_points, src_idx, k=3,
                                     backend=knn_backend)
    return source_points + apply_interpolation(disp, nbr, w, src_idx)


@torch.no_grad()
def ddim_sample_loop(model: PointCloudDiffusionModel,
                     schedule: DiffusionSchedule, shape_like: torch.Tensor,
                     condition_points: torch.Tensor,
                     num_inference_steps: int = 50,
                     use_hierarchical: Optional[bool] = None,
                     x_init: Optional[torch.Tensor] = None,
                     cond_priorities: Optional[torch.Tensor] = None,
                     step_priorities: Optional[torch.Tensor] = None,
                     fps_starts: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Plain DDIM sampling (no CFG, no content anchor): every step runs the
    model's full forward (condition voxel downsample, style encoder, voxel
    downsample of the state, denoiser) and, when hierarchical, interpolates
    the unselected points' noise from the coarse prediction.
    ``shape_like`` supplies the output shape [B, N, 3]. Returns float32.

    Draws that may be passed in: ``x_init`` [B, N, 3], ``cond_priorities``
    [steps, B, Nc] and ``step_priorities`` [steps, B, N] (each step's voxel
    priorities of the condition cloud and of the state), ``fps_starts``
    [2, B] (used at every step). The rest come from ``generator``: the
    initial noise, then per step the condition priorities, the FPS starts
    and the state's priorities."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    B, N, _ = shape_like.shape
    if use_hierarchical is None:
        use_hierarchical = N > cfg.global_points
    if x_init is None:
        x = torch.randn((B, N, 3), generator=generator, device=device,
                        dtype=torch.float32)
    else:
        x = x_init.to(device=device, dtype=torch.float32)
    ts, t_prev = _step_schedule(schedule.num_timesteps, num_inference_steps)
    knn_backend = resolve_sampler_knn_backend(cfg)

    for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
        t_in = torch.full((B,), t, dtype=torch.int64, device=device)
        pred, idx, _ = model.forward(
            x, t_in, condition_points, cond_drop_prob=0.0,
            use_hierarchical=use_hierarchical, train=False,
            cond_priority=None if cond_priorities is None
            else cond_priorities[s],
            noisy_priority=None if step_priorities is None
            else step_priorities[s],
            fps_starts=fps_starts, generator=generator)
        pred = pred.float()
        if idx is not None:
            pred = _upsample_unknown(x, idx, pred, knn_backend)
        x = ddim_step(schedule, x, pred, t, tp,
                      target_range=cfg.target_range)
    return x
