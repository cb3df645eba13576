"""In-context attribution of the hierarchical sampling step on the PyTorch
port: the counterpart of ``examples/profile_sampler_step.py``, with its
variants and environment knobs.

A copy of ``guided_sample_loop``'s hierarchical body
(``models/samplers.py::_guided_body``) runs ``--steps`` steps (10) at
``Config()`` width (B = 1, N = 120,000, M = 30,000, bf16) with one
component stubbed at a time. The difference between the full step and a
stubbed one is that component's marginal cost in context, which
microbenchmarks of the isolated operations do not see. Variants:

  full          voxel order + partition, the denoiser on the cond/uncond
                pair, the grid interpolation with its fallback ladder, the
                120k assembly scatter, the DDIM update;
  noknn         the interpolation replaced by a cheap stand-in;
  nofallback    the grid's build and query pass only (``_grid_knn_core``),
                unsafe rows left as they are (inexact: a timing probe of
                the ladder's cost);
  nopatchbrute  the ladder kept, its brute-force kNN + interpolation of
                the patched rows stubbed;
  nodenoise     the denoiser replaced by a scaled copy of the coarse points;
  novoxel       the first M points taken as the coarse set (no voxel sort);
  noassembly    the 120k scatter back to point order dropped: the field
                left in the permuted order ``_unpermute_assemble``
                concatenates before its scatter (the JAX script's stand-in,
                a mean broadcast, costs more than the scatter on the card);
  noddim        the DDIM update replaced by one axpy;
  bare          every component stubbed: the loop's floor.

On the card each variant's steps are one CUDA graph (``models/capture.py``,
keyed by the variant, every earlier graph dropped first), replayed
``--reps`` times (10) between CUDA events. Every variant but ``full`` is
replayed in alternation with a ``full`` graph made anew beside it, and its
marginal is the difference of the two medians over those turns; a
marginal within the spread (largest - least) of either reading is printed
as unresolved (``profile_common_torch.marginal``). Each variant prints its
ms a step (median), its spread, its marginal and its kernel launches a
step, checked against what it stubs. The ``full`` body is checked to give
exactly what ``_guided_body`` gives over the same steps from the same x,
style and step priorities, and a replayed ``full`` call's device kernels
are printed by name under ``torch.profiler`` (the top 15 by device time,
with launches) with the device's busy share. One profiled replay of each
other variant gives its device busy time against ``full``'s and the
kernels whose time moved most (``[device]`` lines): whether a marginal is
device work removed, or work moved elsewhere. The JAX script's chained
``jit`` and forced host transfer worked round a host relay that the card
does not have; here the graph is the unit.

Usage: python examples/profile_sampler_step_torch.py [variant ...]
           [--steps 10] [--reps 10] [--device cuda|cpu]
           [--config FIELD=VALUE ...]
Env knobs (``profile_common_torch.grid_knobs``, production defaults):
PCST_PROF_SLOT_CAP, PCST_PROF_Z_HALO, PCST_PROF_GRID (e.g. "16,8,8"),
PCST_PROF_FALLBACK_CAP, PCST_PROF_TQ, PCST_PROF_XY_HALO (int or "Hx,Hy").
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import statistics
import sys
from typing import Optional

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    capture, make_schedule, samplers)
from pointcloud_style_transfer_torch.models.diffusion import \
    ddim_step  # noqa: E402
from pointcloud_style_transfer_torch.ops import (  # noqa: E402
    grid_knn, voxel_downsample, voxel_downsample_partition)
from pointcloud_style_transfer_torch.ops.voxel import voxel_order  # noqa: E402

VARIANTS = ("full", "noknn", "nofallback", "nopatchbrute", "nodenoise",
            "novoxel", "noassembly", "noddim", "bare")
# the port's kernel launches of one step of each variant: the grid's
# interpolation and the ladder's one counted brute-force patch launch (at
# B > 1 one flat-batched pass and one patch launch for the batch);
# ``noup`` is the batched twin's (profile_sampler_step_batched_torch.py)
_GRID = {"grid_interp": 1, "knn_topk": 1}
LAUNCHES = {v: _GRID for v in VARIANTS} | {
    "noknn": {}, "bare": {}, "noup": {}, "nofallback": {"grid_interp": 1},
    "nopatchbrute": {"grid_interp": 1}}
# the components each variant's body runs a step at B = 1
_ALL = ("voxel", "denoise", "grid", "assembly", "ddim")
COMPONENTS = {
    "full": _ALL,
    "noknn": ("voxel", "denoise", "assembly", "ddim"),
    "nofallback": ("voxel", "denoise", "grid_core", "assembly", "ddim"),
    "nopatchbrute": _ALL + ("patch_stub",),
    "nodenoise": ("voxel", "grid", "assembly", "ddim"),
    "novoxel": ("denoise", "grid", "assembly", "ddim"),
    "noassembly": ("voxel", "denoise", "grid", "ddim"),
    "noddim": ("voxel", "denoise", "grid", "assembly"),
    "noup": ("voxel", "denoise", "ddim"),
    "bare": ()}


def components(variant: str, B: int = 1) -> set:
    """The components ``variant``'s body runs a step at ``B`` clouds: at
    B > 1 the grid and the assembly are one, ``_upsample_unknown``."""
    parts = set(COMPONENTS[variant])
    if B > 1 and "grid" in parts:
        parts = parts - {"grid", "assembly"} | {"upsample"}
    return parts


def sampler_inputs(model, B: int, steps: int,
                   generator: torch.Generator) -> dict:
    """Seeded draws for ``B`` clouds of ``Config()``'s N points: the
    source and condition clouds (normal x 0.9, as the JAX scripts draw
    them), the initial noise, the condition's voxel priorities, the
    encoder's FPS starts and each step's voxel priorities; and the style
    vector ``_guided_body`` computes from them ([2B, F]: the cond rows,
    then zeros)."""
    cfg, dev = model.config, model.device
    N, M = cfg.total_points, cfg.global_points

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    src, cond, x0 = randn(B, N, 3) * 0.9, randn(B, N, 3) * 0.9, randn(B, N, 3)
    cond_priority = torch.rand((B, N), generator=generator, device=dev)
    fps_starts = model.net.style_encoder.encoder.draw_fps_starts(
        M, B, generator, dev)
    step_priorities = torch.rand((steps, B, N), generator=generator,
                                 device=dev)
    cond_ds, _ = voxel_downsample(cond, M, priority=cond_priority)
    style = model.encode_style(cond_ds, fps_starts)
    return {"source": src, "condition": cond, "x_init": x0,
            "cond_priority": cond_priority, "fps_starts": fps_starts,
            "step_priorities": step_priorities,
            "style_in": torch.cat([style, torch.zeros_like(style)])}


def make_body(model, variant: str, steps: int, guidance: float,
              knobs: Optional[dict], trace: collections.Counter):
    """The variant's loop over the inputs ``x``, ``source``, ``style_in``,
    ``step_priorities`` and the schedule's tensors, at the B clouds of
    ``x``. At B > 1 the upsample is ``samplers._upsample_unknown``'s
    flat-batched grid with its assembly, and only ``full``, ``noup``,
    ``novoxel``, ``nodenoise`` and ``noddim`` are defined. ``knobs`` are
    the grid's keywords ``nofallback`` calls its core with."""
    cfg = model.config
    M = cfg.global_points
    core_kw = {k: v for k, v in (knobs or {}).items() if k != "fallback_cap"}

    def step(ins, s, x, t, tp, schedule):
        B, N, _ = x.shape
        if variant == "bare":
            return x - 0.05 * torch.tanh(x * (1.0 + t * 1e-6))
        dev = x.device
        if variant == "novoxel":
            x_coarse, unk_xyz = x[:, :M], x[:, M:]
            x_idx = torch.arange(M, device=dev).expand(B, M)
            unknown = torch.arange(M, N, device=dev).expand(B, N - M)
        else:
            trace["voxel"] += 1
            order = voxel_order(x, M, priority=ins["step_priorities"][s])
            x_coarse, x_idx, unknown, unk_xyz = voxel_downsample_partition(
                x, M, order=order)
        if variant == "nodenoise":
            guided = x_coarse * 0.1
        else:
            trace["denoise"] += 1
            t_in = torch.full((2 * B,), t, dtype=torch.int64, device=dev)
            nc = model.predict_noise(torch.cat([x_coarse, x_coarse]), t_in,
                                     ins["style_in"])
            nc_cond, nc_unc = nc.float().chunk(2)
            guided = nc_unc + guidance * (nc_cond - nc_unc)
        if variant == "noup":
            noise = torch.cat([guided, unk_xyz * 0.1], dim=1)
        elif B > 1:
            trace["upsample"] += 1
            noise = samplers._upsample_unknown(
                x, x_idx, guided, "grid", unknown=unknown, ref_xyz=x_coarse,
                unknown_xyz=unk_xyz)
        else:
            if variant == "noknn":
                vals = unk_xyz * 0.1
            elif variant == "nofallback":
                trace["grid_core"] += 1
                vals = grid_knn._grid_knn_core(
                    unk_xyz[0], x_coarse[0], 3, values=guided[0],
                    **core_kw)[0][None]
            else:  # _upsample_unknown's B = 1 grid path
                trace["grid"] += 1
                vals = samplers._grid_interpolate(unk_xyz[0], x_coarse[0],
                                                  guided[0], 3)[None]
            if variant == "noassembly":
                noise = torch.cat([guided, vals], dim=1)
            else:
                trace["assembly"] += 1
                noise = samplers._unpermute_assemble(x_idx, unknown, guided,
                                                     vals, N)
        if variant == "noddim":
            return x - 0.05 * noise
        trace["ddim"] += 1
        return ddim_step(schedule, x, noise, t, tp,
                         source_points=ins["source"],
                         content_anchor=cfg.content_anchor,
                         target_range=cfg.target_range)

    def body(ins: dict) -> torch.Tensor:
        trace["runs"] += 1
        schedule = samplers._schedule_of(ins)
        ts, t_prev = samplers._step_schedule(schedule.num_timesteps, steps)
        x = ins["x"]
        for s, (t, tp) in enumerate(zip(ts.tolist(), t_prev.tolist())):
            x = step(ins, s, x, t, tp, schedule)
        return x
    return body


def patch_stub(trace: collections.Counter):
    """``grid_knn._brute_interp`` for ``nopatchbrute``: the patched rows'
    values from the rows themselves, on the device."""
    def stub(rows, ref, values, k, eps, row_ids=None, count=None,
             plan_rows=None):
        trace["patch_stub"] += 1
        return rows * 0.1
    return stub


def run_variants(model, variants, steps: int, reps: int, inputs: dict,
                 schedule, knobs: Optional[dict], guidance: float, key_tag,
                 profiled: bool = False) -> dict:
    """Each variant's body through ``common.measure`` with its own graph:
    every earlier graph dropped (``capture.release()``) and the variant in
    the key. ``full`` is timed over ``reps`` replays; every other variant
    over ``reps`` turns with a ``full`` graph made anew beside it, the two
    replayed in alternation (``common.timed_turns``), so that its marginal
    (``common.marginal``) compares calls made side by side. Returns per
    variant its outputs, ``ms`` (and ``full_ms``, the turns of ``full``
    beside it), launches and ``trace``: the counts of the components its
    body ran, of its Python runs (``runs``; a replay runs none) and of its
    calls (``calls``); with ``profiled``, on the card, one more replay of
    its own under ``torch.profiler`` (``profile``:
    ``common.device_kernels``)."""
    device = model.device
    ins = {"x": inputs["x_init"], "source": inputs["source"],
           "style_in": inputs["style_in"],
           "step_priorities": inputs["step_priorities"],
           **samplers._schedule_inputs(schedule)}

    def prepare(variant):
        trace = collections.Counter()
        body = make_body(model, variant, steps, guidance, knobs, trace)
        key = (key_tag, variant, steps, float(guidance), repr(knobs),
               capture.model_key(model))
        stub = (patch_stub(trace) if variant == "nopatchbrute"
                else grid_knn._brute_interp)

        def run():
            trace["calls"] += 1
            with common.patched(grid_knn, "_brute_interp", stub):
                return common.run_body(key, body, ins, model.net, device)
        return run, trace

    out = {}
    for variant in variants:
        capture.release()
        run, trace = prepare(variant)
        if variant == "full":
            res = common.measure(run, reps, device)
        else:
            res = common.measure(run, 0, device)
            run_full, _ = prepare("full")
            for _ in range(2):  # its eager call and its capture
                run_full()
            res["full_ms"], res["ms"] = common.timed_turns(
                [run_full, run], reps, device)
        if profiled and common.graphed(device):
            res["profile"] = common.device_kernels(run)
        res["trace"] = trace
        out[variant] = res
    capture.release()
    return out


def check_variant(variant: str, res: dict, steps: int, shape,
                  device: torch.device) -> None:
    """The variant's outputs finite, of ``shape`` ([B, N, 3]) and identical
    across its calls; its body run by Python at its first two calls only
    on the card (eager, capture: no graph of another body replayed) and at
    every call on the CPU; the components it ran and, on the card, its
    launches."""
    first = res["first"]
    if tuple(first.shape) != tuple(shape) or not torch.isfinite(first).all():
        raise RuntimeError(f"{variant}: output {tuple(first.shape)} not "
                           f"finite or not of shape {tuple(shape)}")
    for name in ("second", "last"):
        if not torch.equal(res[name], first):
            raise RuntimeError(f"{variant}: the {name} call differs from the "
                               "first")
    trace = res["trace"]
    runs = 2 if common.graphed(device) else trace["calls"]
    want = {c: steps * runs for c in components(variant, shape[0])}
    got = {c: n for c, n in trace.items() if c not in ("runs", "calls")}
    if trace["runs"] != runs or got != want:
        raise RuntimeError(f"{variant}: the body ran {trace['runs']} times "
                           f"(want {runs}), components {got} != {want}")
    want_launches = {k: v * steps for k, v in LAUNCHES[variant].items()}
    if device.type == "cuda" and res["launches"] != want_launches:
        raise RuntimeError(f"{variant}: a call launched {res['launches']} != "
                           f"{want_launches}")


def readings_of(res: dict, steps: int) -> dict:
    """A variant's ms a step (median over its replays), best, spread and
    runs; beside ``full``, its marginal (``common.marginal``) against the
    ``full`` turns it alternated with; its launches a step and the
    components it ran."""
    per = [ms / steps for ms in res["ms"]]
    return {"ms_per_step": statistics.median(per), "best_ms_per_step": min(per),
           "spread": common.spread(per), "runs_ms_per_step": per,
           "marginal": None if "full_ms" not in res else common.marginal(
               [ms / steps for ms in res["full_ms"]], per),
           "launches_per_step": {k: v / steps
                                 for k, v in res["launches"].items()},
           "components": sorted(c for c in res["trace"]
                                if c not in ("runs", "calls"))}


def device_shift(full: dict, prof: dict, steps: int) -> dict:
    """Where a variant's marginal went on the device, from one profiled
    replay of each: its device busy ms a step, ``full``'s minus it, and
    the three kernels whose device ms a step moved most from ``full``'s
    (negative: the variant spends more)."""
    a, b = full["by_name"], prof["by_name"]
    moved = sorted((((a.get(k, 0.0) - b.get(k, 0.0)) / steps, k)
                    for k in set(a) | set(b)), key=lambda m: -abs(m[0]))[:3]
    busy = prof["busy_ms"] / steps
    saved = full["busy_ms"] / steps - busy
    return {"busy_ms_per_step": busy, "busy_saved_ms": saved,
            "moved": [{"name": k[:120], "saved_ms": d} for d, k in moved],
            "note": f"device busy {busy:.4f} ms/step, {saved:+.4f} against "
                    "full; moved most: " + "; ".join(
                        f"{d:+.4f} {k[:70]}" for d, k in moved)}


def guided_body_reference(model, inputs: dict, schedule, steps: int,
                          guidance: float) -> torch.Tensor:
    """``samplers._guided_body`` over the same draws, eagerly."""
    ins = {n: inputs[n] for n in ("source", "condition", "x_init",
                                  "cond_priority", "fps_starts",
                                  "step_priorities")}
    ins.update(samplers._schedule_inputs(schedule))
    return samplers._guided_body(model, ins, steps, guidance, True, "grid",
                                 None, None, None)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--reps", type=int, default=10)
    common.script_args(parser)
    args = parser.parse_args(argv)
    bad = set(args.variants) - set(VARIANTS)
    if bad:
        parser.error(f"unknown variants {sorted(bad)}; choose from {VARIANTS}")

    model = common.random_model(args.device, common.config_of(args))
    device, cfg = model.device, model.config
    N, M = cfg.total_points, cfg.global_points
    if N <= M:
        parser.error(f"the hierarchical step needs N > M ({N}, {M})")
    schedule = make_schedule(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(common.SEED + 3)
    inputs = sampler_inputs(model, 1, args.steps, gen)
    knobs = common.grid_knobs()
    card = common.device_name(device)
    print(f"device={card} N={N} M={M} steps={args.steps} reps={args.reps} "
          f"grid={knobs}", flush=True)
    # the knobs bound to the entry point the sampler's grid path calls
    bound = functools.partial(grid_knn.grid_knn_interpolate_layout, **knobs)
    with common.patched(grid_knn, "grid_knn_interpolate_layout", bound):
        res = run_variants(model, args.variants, args.steps, args.reps,
                           inputs, schedule, knobs, cfg.guidance_scale,
                           "profile_sampler_step", profiled=True)
        identical = None
        if "full" in res:
            want = guided_body_reference(model, inputs, schedule, args.steps,
                                         cfg.guidance_scale)
            identical = torch.equal(res["full"]["first"], want)
            if not identical:
                raise RuntimeError(
                    "the full body differs from _guided_body: max |d| "
                    f"{(res['full']['first'] - want).abs().max().item()}")
    readings = {}
    for variant in args.variants:
        check_variant(variant, res[variant], args.steps, (1, N, 3), device)
        r = readings[variant] = readings_of(res[variant], args.steps)
        note = ("" if r["marginal"] is None else "  (component ~"
                + common.marginal_note(r["marginal"]) + ")")
        print(f"{variant:12s} {r['ms_per_step']:8.4f} ms/step (best "
              f"{r['best_ms_per_step']:.4f}, spread "
              f"{100 * r['spread']:.1f}%) launches/step "
              f"{r['launches_per_step']}{note}", flush=True)
    if identical is not None:
        print(f"full body == _guided_body over {args.steps} steps (same x, "
              "style and step priorities): identical")
    profile = res.get("full", {}).get("profile")
    if profile:
        common.print_kernels("[replayed full]", f"one replay of "
                             f"{args.steps} steps", profile, card)
        for variant in args.variants:
            if variant != "full" and "profile" in res[variant]:
                r = readings[variant]
                r["device"] = device_shift(profile, res[variant]["profile"],
                                           args.steps)
                print(f"[device] {variant:12s} " + r["device"]["note"])
    return {"device": card, "N": N, "M": M, "steps": args.steps,
            "reps": args.reps, "knobs": knobs, "variants": readings,
            "full_equals_guided_body": identical, "profile": profile or None,
            "outputs": {v: res[v]["first"] for v in args.variants}}


if __name__ == "__main__":
    main()
