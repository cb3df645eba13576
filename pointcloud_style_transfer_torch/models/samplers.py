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

import contextlib
import dataclasses
import functools
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
from ..utils import profiling
from ..utils.profiling import annotate, device_span
from .capture import model_key, run_captured
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
    grid backend takes one cloud in its layout order, and B > 1 clouds
    through ``grid_knn_interpolate`` (flat-batched where the grid allows).
    ``selections`` (a dict) pins the
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
        if B == 1:
            vals = _grid_interpolate(q[0], ref_xyz[0], coarse_vals[0],
                                     k)[None]
        else:  # flat-batched when the grid allows, as on the TPU
            vals = grid_knn.grid_knn_interpolate(q, ref_xyz, coarse_vals, k)
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


def _draws(device: torch.device, *wanted) -> list:
    """Each ``(given, draw)`` of ``wanted`` in turn: ``given`` on ``device``
    (float32, or int64 for indices), else ``draw()``, else None where the
    call needs no such draw (``draw`` None). The draws are taken here,
    before the loop, in the order the eager loop took them, so that one
    seed gives the same numbers on the CPU and, before a captured loop, on
    the card."""
    out = []
    for given, draw in wanted:
        if given is not None:
            given = given.to(device)
            out.append(given.float() if given.is_floating_point() else
                       given.long())
        else:
            out.append(None if draw is None else draw())
    return out


def _schedule_inputs(schedule: DiffusionSchedule) -> dict:
    return {f"schedule.{f.name}": getattr(schedule, f.name)
            for f in dataclasses.fields(schedule)}


def _schedule_of(ins: dict) -> DiffusionSchedule:
    return DiffusionSchedule(**{f.name: ins[f"schedule.{f.name}"]
                                for f in dataclasses.fields(
                                    DiffusionSchedule)})


def _graphed(device: torch.device) -> bool:
    """Whether a sampler call on ``device`` runs through the capture
    runner: on the card."""
    return device.type == "cuda"


def _run(model: PointCloudDiffusionModel, key: tuple, body, inputs: dict,
         eager: bool = False, split=None) -> torch.Tensor:
    """``body(inputs)``: eagerly on the CPU or where ``eager`` says the call
    needs the host between steps, else on the card through
    ``models.capture`` under ``key``: eagerly the first time, from a CUDA
    graph captured the second time and replayed since (a failed capture or
    replay raises). With ``split`` (``parallel.sharded_sampler.RowSplit``)
    the key holds the split, and the graph its collectives, on whose
    branch its group's ranks agree at every call."""
    inputs = {n: t for n, t in inputs.items() if t is not None}
    if eager or not _graphed(model.device):
        return body(inputs)
    return run_captured(
        lambda: (key, None if split is None else split.key(),
                 model_key(model)),
        body, inputs, model.net, groups=() if split is None else split.groups)


@torch.no_grad()
@profiling.one_call
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
    ``fps_starts`` [2, B] the encoder's FPS start indices. The rest are
    drawn from ``generator`` before the loop (``_draws``). The hierarchical
    branch runs when N > global_points unless ``use_hierarchical`` says
    otherwise. ``selections`` (a dict)
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
    cloud. A denoiser that mixes points (``PointETransformer``) needs every
    row at once, so a ``mesh`` call with it raises.

    On the card the whole call after the draws (condition downsample, style
    encoder, every step) is one CUDA graph (``models.capture``), captured
    at the second call with the same static arguments (the first runs
    eagerly and is its warm-up) and replayed with the same results as the
    eager loop, on every ``knn_backend``. It runs eagerly on the CPU and
    with ``selections`` (a dict read and written every step). With
    ``mesh`` the graph holds the all-gathers of the shares (the
    counterparts of JAX's inside its ``shard_map``), and the axis's ranks
    agree on every call's branch (``models.capture``).

    Its spans (``utils.profiling``): ``sampler.draws`` on the host, and in
    the body a device span ``sampler.step`` a step holding
    ``sampler.partition`` (the voxel order and partition),
    ``sampler.denoiser`` (``predict_noise``, with the row split's gather)
    and ``sampler.upsample``; the CFG combine and the DDIM step are the
    step's own time. The direct branch's steps hold ``sampler.denoiser``
    alone."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    source_points = source_points.to(device=device, dtype=torch.float32)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    B, N, _ = source_points.shape
    Nc = condition_points.shape[1]
    M = cfg.global_points
    if use_hierarchical is None:
        use_hierarchical = N > M
    if knn_backend is None:
        knn_backend = resolve_sampler_knn_backend(cfg)
    split = rows = None
    if mesh is not None:
        if model.net.noise_predictor.mixes_points:
            raise ValueError(
                "the point-sharded sampler runs the denoiser on one rank's "
                "rows, which is wrong for a denoiser that mixes points "
                f"({type(model.net.noise_predictor).__name__})")
        from ..parallel.sharded_sampler import RowSplit
        split = RowSplit(mesh, axis_name, device.type)
        if use_hierarchical:
            split.check(N - M, "unknown count N-M")
            rows = split if M % split.n == 0 else None
    encoder = model.net.style_encoder.encoder
    rand = functools.partial(torch.rand, generator=generator, device=device)
    with annotate("sampler.draws"):
        cond_priority, fps_starts, x_init, step_priorities = _draws(
            device,
            (cond_priority, (lambda: rand((B, Nc))) if Nc > M else None),
            (fps_starts, lambda: encoder.draw_fps_starts(min(Nc, M), B,
                                                         generator, device)),
            (x_init, lambda: torch.randn((B, N, 3), generator=generator,
                                         device=device)),
            (step_priorities, (lambda: torch.stack([
                rand((B, N)) for _ in range(num_inference_steps)]))
             if use_hierarchical else None))
    inputs = dict(source=source_points, condition=condition_points,
                  x_init=x_init, cond_priority=cond_priority,
                  fps_starts=fps_starts, step_priorities=step_priorities,
                  **_schedule_inputs(schedule))

    def body(ins: dict) -> torch.Tensor:
        return _guided_body(model, ins, num_inference_steps, guidance_scale,
                            use_hierarchical, knn_backend, selections, split,
                            rows)
    key = ("guided", num_inference_steps, float(guidance_scale),
           use_hierarchical, knn_backend)
    return _run(model, key, body, inputs, selections is not None, split)


def _guided_body(model: PointCloudDiffusionModel, ins: dict, steps: int,
                 guidance_scale: float, use_hierarchical: bool,
                 knn_backend: str, selections: Optional[dict], split,
                 rows) -> torch.Tensor:
    """``guided_sample_loop`` after its draws, from its inputs ``ins``."""
    cfg = model.config
    device = model.device
    schedule = _schedule_of(ins)
    source_points = ins["source"]
    B = source_points.shape[0]
    M = cfg.global_points
    step_priorities = ins.get("step_priorities")
    cond_ds, _ = voxel_downsample(ins["condition"], M,
                                  priority=ins.get("cond_priority"))
    style = model.encode_style(cond_ds, ins["fps_starts"])
    style_in = torch.cat([style, torch.zeros_like(style)], dim=0)  # [2B, F]
    x = ins["x_init"]
    ts, t_prev = _step_schedule(schedule.num_timesteps, steps)

    for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
        with device_span("sampler.step"):
            if use_hierarchical:
                t_in = torch.full((2 * B,), t, dtype=torch.int64,
                                  device=device)
                key = f"step{s}.voxel"
                with device_span("sampler.partition"):
                    _record_points(selections, key, points=x)
                    order = None if selections is None else \
                        selections.get(key)
                    if order is None:
                        order = voxel_order(x, M, priority=step_priorities[s])
                        if selections is not None:
                            selections[key] = order
                    x_coarse, x_idx, x_unk, x_unk_xyz = \
                        voxel_downsample_partition(x, M, order=order)
                x2 = torch.cat([x_coarse, x_coarse], dim=0)
                with device_span("sampler.denoiser"):
                    if rows is None:
                        noise_coarse = model.predict_noise(x2, t_in, style_in)
                    else:
                        noise_coarse = rows.gather(model.predict_noise(
                            rows.local(x2), t_in, style_in))
                # CFG combine at coarse resolution: interpolation is linear,
                # so combine-then-upsample equals upsample-then-combine
                guided_coarse = _cfg_combine(noise_coarse, guidance_scale)
                with device_span("sampler.upsample"):
                    final_noise = _upsample_unknown(
                        x, x_idx, guided_coarse, knn_backend, unknown=x_unk,
                        ref_xyz=x_coarse, unknown_xyz=x_unk_xyz,
                        selections=selections, key=f"step{s}.knn",
                        split=split)
            else:
                final_noise = _guided_step(model, x, t, style_in,
                                           guidance_scale, spans=True)

            x = ddim_step(schedule, x, final_noise, t, tp,
                          source_points=source_points,
                          content_anchor=cfg.content_anchor,
                          target_range=cfg.target_range)
    return x


def _cfg_combine(pred: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """The classifier-free guided noise from the denoiser's prediction on
    the [cond; uncond] batch."""
    nc, nu = pred.float().chunk(2)
    return nu + guidance_scale * (nc - nu)


def _guided_step(model: PointCloudDiffusionModel, x: torch.Tensor, t: int,
                 style_in: torch.Tensor, guidance_scale: float,
                 spans: bool = False) -> torch.Tensor:
    """The CFG noise of one step at x's own resolution; with ``spans`` the
    denoiser's call is the device span ``sampler.denoiser``."""
    B = x.shape[0]
    t_in = torch.full((2 * B,), t, dtype=torch.int64, device=x.device)
    x2 = torch.cat([x, x], dim=0)
    span = device_span("sampler.denoiser") if spans else \
        contextlib.nullcontext()
    with span:
        pred = model.predict_noise(x2, t_in, style_in)
    return _cfg_combine(pred, guidance_scale)


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

    Draws that may be passed in, else taken from ``generator`` before the
    loop in this order: ``cond_priority`` [B, Nc], ``fps_starts`` [2, B],
    ``src_priority`` [B, N] the source's voxel priorities, ``x_init``
    [B, Mc, 3] the initial noise at coarse resolution. On the card the call
    after the draws is one CUDA graph, as ``guided_sample_loop``'s."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    source_points = source_points.to(device=device, dtype=torch.float32)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    B, N, _ = source_points.shape
    Nc = condition_points.shape[1]
    M = cfg.global_points
    coarse = use_hierarchical and N > M
    encoder = model.net.style_encoder.encoder
    knn_backend = resolve_sampler_knn_backend(cfg)
    rand = functools.partial(torch.rand, generator=generator, device=device)
    cond_priority, fps_starts, src_priority, x_init = _draws(
        device,
        (cond_priority, (lambda: rand((B, Nc))) if Nc > M else None),
        (fps_starts, lambda: encoder.draw_fps_starts(min(Nc, M), B,
                                                     generator, device)),
        (src_priority, (lambda: rand((B, N))) if coarse else None),
        (x_init, lambda: torch.randn((B, M if coarse else N, 3),
                                     generator=generator, device=device)))
    inputs = dict(source=source_points, condition=condition_points,
                  x_init=x_init, cond_priority=cond_priority,
                  fps_starts=fps_starts, src_priority=src_priority,
                  **_schedule_inputs(schedule))

    def body(ins: dict) -> torch.Tensor:
        return _coarse_body(model, ins, num_inference_steps, guidance_scale,
                            coarse, knn_backend)
    key = ("coarse", num_inference_steps, float(guidance_scale), coarse,
           knn_backend)
    return _run(model, key, body, inputs)


def _coarse_body(model: PointCloudDiffusionModel, ins: dict, steps: int,
                 guidance_scale: float, coarse: bool, knn_backend: str
                 ) -> torch.Tensor:
    """``guided_sample_loop_coarse`` after its draws."""
    cfg = model.config
    schedule = _schedule_of(ins)
    source_points = ins["source"]
    M = cfg.global_points
    cond_ds, _ = voxel_downsample(ins["condition"], M,
                                  priority=ins.get("cond_priority"))
    style = model.encode_style(cond_ds, ins["fps_starts"])
    style_in = torch.cat([style, torch.zeros_like(style)], dim=0)
    if coarse:
        src_coarse, src_idx = voxel_downsample(
            source_points, M, priority=ins["src_priority"])
    else:
        src_coarse, src_idx = source_points, None
    x = ins["x_init"]
    ts, t_prev = _step_schedule(schedule.num_timesteps, steps)
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
    [2, B] (used at every step) or [steps, 2, B] (one pair a step). The
    rest are drawn from ``generator`` before the loop, in the order the
    steps take them: the initial noise, then per step the condition
    priorities, the FPS starts and the state's priorities. On the card the
    loop after the draws is one CUDA graph, as ``guided_sample_loop``'s."""
    cfg = model.config
    device = model.device
    schedule = schedule.to(device)
    condition_points = condition_points.to(device=device, dtype=torch.float32)
    B, N, _ = shape_like.shape
    Nc = condition_points.shape[1]
    M = cfg.global_points
    steps = num_inference_steps
    if use_hierarchical is None:
        use_hierarchical = N > M
    encoder = model.net.style_encoder.encoder
    n_style = M if use_hierarchical and Nc > M else Nc
    (x_init,) = _draws(device, (x_init, lambda: torch.randn(
        (B, N, 3), generator=generator, device=device)))
    if fps_starts is not None and fps_starts.dim() == 2:  # every step's
        fps_starts = fps_starts.expand(steps, *fps_starts.shape)
    rand = functools.partial(torch.rand, generator=generator, device=device)
    per_step = {  # a step's draws in the eager loop's order (None: not drawn)
        "cond": (lambda: rand((B, Nc))) if cond_priorities is None
        and use_hierarchical and Nc > M else None,
        "fps": (lambda: encoder.draw_fps_starts(n_style, B, generator,
                                                device))
        if fps_starts is None else None,
        "state": (lambda: rand((B, N))) if step_priorities is None
        and use_hierarchical and N > M else None}
    drawn: dict = {name: [] for name in per_step}
    for _ in range(steps):
        for name, draw in per_step.items():
            if draw is not None:
                drawn[name].append(draw())
    cond_priorities, fps_starts, step_priorities = _draws(device, *(
        (given, (lambda d=drawn[name]: torch.stack(d)) if drawn[name]
         else None)
        for name, given in zip(per_step, (cond_priorities, fps_starts,
                                          step_priorities))))
    inputs = dict(x_init=x_init, condition=condition_points,
                  cond_priorities=cond_priorities,
                  fps_starts=None if fps_starts is None
                  else fps_starts.contiguous(),
                  step_priorities=step_priorities,
                  **_schedule_inputs(schedule))
    knn_backend = resolve_sampler_knn_backend(cfg)

    def body(ins: dict) -> torch.Tensor:
        return _ddim_body(model, ins, steps, use_hierarchical, knn_backend)
    key = ("ddim", steps, use_hierarchical, knn_backend)
    return _run(model, key, body, inputs)


def _ddim_body(model: PointCloudDiffusionModel, ins: dict, steps: int,
               use_hierarchical: bool, knn_backend: str) -> torch.Tensor:
    """``ddim_sample_loop`` after its draws."""
    cfg = model.config
    schedule = _schedule_of(ins)
    x = ins["x_init"]
    B = x.shape[0]
    cond_priorities = ins.get("cond_priorities")
    step_priorities = ins.get("step_priorities")
    ts, t_prev = _step_schedule(schedule.num_timesteps, steps)
    for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
        t_in = torch.full((B,), t, dtype=torch.int64, device=x.device)
        pred, idx, _ = model.forward(
            x, t_in, ins["condition"], cond_drop_prob=0.0,
            use_hierarchical=use_hierarchical, train=False,
            cond_priority=None if cond_priorities is None
            else cond_priorities[s],
            noisy_priority=None if step_priorities is None
            else step_priorities[s],
            fps_starts=ins["fps_starts"][s])
        pred = pred.float()
        if idx is not None:
            pred = _upsample_unknown(x, idx, pred, knn_backend)
        x = ddim_step(schedule, x, pred, t, tp,
                      target_range=cfg.target_range)
    return x
