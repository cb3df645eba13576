"""Stage costs of the production grid interpolation on the PyTorch port:
the counterpart of ``examples/profile_interp_stages.py``, at the sampler's
geometry (90,000 queries, 30,000 refs, k = 3, ``ops/grid_knn.py``'s
defaults or the environment knobs):

  build      ``_build_struct`` (z sort skipped where whole columns fit);
  values     ``_sorted_values``: the values gathered into the grid's order;
  layout     ``_layout_slots``: cell assignment, the padded layout, the
             slot tables;
  kernel     ``grid_interp`` alone (the slot-run kernel) on that layout;
  margins    ``_safe_rows``: the exactness test of each row;
  querypass  ``_query_pass`` in query order (layout, kernel, margins and
             the gather back to query order), and the same with the
             kernel stubbed (same shapes), whose difference is the kernel
             in context (unresolved where within either one's spread);
  ladder     ``_apply_fallback`` on the pass's unsafe rows (the counted
             brute-force patch and its scatter);
  unsort     the layout-to-query scatter ``samplers._grid_interpolate``
             makes of the layout output;
  interp     the whole call the sampler makes
             (``grid_knn_interpolate_layout`` + the unsort);
  brute      the brute-force interpolation of every query, what
             ``knn_backend="pallas"`` pays.

Each stage runs ``--chain`` times (10) in one body; on the card the body is
one CUDA graph replayed ``--reps`` times (5) between CUDA events, and a
replay of the whole call is profiled (device kernels by name, busy
share). ``stages`` takes given clouds and grid keywords
(``chip_smoke.py``'s kernels phase calls it on its own, with its own
grid). The JAX script's chained ``jit`` and host transfer
worked round a host relay the card does not have.

Usage: python examples/profile_interp_stages_torch.py [--queries 90000]
           [--refs 30000] [--chain 10] [--reps 5] [--device cuda|cpu]
Env knobs: PCST_PROF_GRID, PCST_PROF_TQ, PCST_PROF_SLOT_CAP,
PCST_PROF_FALLBACK_CAP (``profile_common_torch.grid_knobs``).
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    capture, samplers)
from pointcloud_style_transfer_torch.ops import grid_knn  # noqa: E402

K = 3
EPS = 1e-8


def _stub_kernel(q_pad, refs_sorted, vals_sorted, st, en, k, eps=1e-8,
                 n_real=None):
    """``grid_interp``'s outputs at its shapes, with no scan."""
    NP = q_pad.shape[0]
    return (q_pad.new_zeros((NP, vals_sorted.shape[1])),
            q_pad.new_zeros((NP, k)))


def stages(q: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
           chain: int = 10, reps: int = 5, knobs: dict | None = None,
           tag: str = "[interp stages]") -> dict:
    """Each stage of one cloud's grid interpolation (query [Nq, 3], ref
    [M, 3], values [M, C] on one device) ``chain`` times a body, timed as
    ``common.measure`` times it: ms a call (median of ``reps``) and
    spread, printed under ``tag``; on the card the whole call's replay
    profiled. Returns the readings."""
    knobs = dict(knobs or common.grid_knobs())
    gs, tq, cap, fb = (knobs["grid_shape"], knobs["tq"], knobs["slot_cap"],
                       knobs["fallback_cap"])
    halos = (knobs["z_halo"], knobs["xy_halo"])
    dev = q.device
    nq, M = q.shape[0], r.shape[0]
    full_z = grid_knn._full_z_ok(M, gs, cap)
    struct = grid_knn._build_struct(r, gs, skip_z_sort=full_z)
    vals_pad = grid_knn._sorted_values(struct, v)
    sl = grid_knn._layout_slots(struct, q, gs, tq, cap, *halos)
    v_s, d_s = grid_knn.grid_interp(sl.q_pad, struct.refs_pad, vals_pad,
                                    sl.st, sl.en, K, EPS, sl.n_real)
    safe = grid_knn._safe_rows(struct, sl, d_s, K, gs).reshape(-1)
    unsafe = ~safe & (sl.orig_pad < nq)
    n_unsafe = int(unsafe.sum())

    def brute(rows, row_ids, count):
        return (grid_knn._brute_interp(rows, r, v, K, EPS, row_ids, count,
                                       grid_knn._patch_plan_rows(fb)),)

    def whole():
        return samplers._grid_interpolate(q, r, v, K)
    stage_fns = {
        "build": lambda: grid_knn._build_struct(r, gs, skip_z_sort=full_z)[0],
        "values": lambda: grid_knn._sorted_values(struct, v),
        "layout": lambda: grid_knn._layout_slots(struct, q, gs, tq, cap,
                                                 *halos).q_pad,
        "kernel": lambda: grid_knn.grid_interp(
            sl.q_pad, struct.refs_pad, vals_pad, sl.st, sl.en, K, EPS,
            sl.n_real)[0],
        "margins": lambda: grid_knn._safe_rows(struct, sl, d_s, K, gs),
        "querypass": lambda: grid_knn._query_pass(
            struct, q, K, gs, tq, cap, *halos, values=v)[0],
        "querypass_stub": lambda: grid_knn._query_pass(
            struct, q, K, gs, tq, cap, *halos, values=v)[0],
        "ladder": lambda: grid_knn._apply_fallback(
            (v_s,), unsafe, sl.q_pad, nq, fb, brute)[0],
        "unsort": lambda: v.new_empty((nq + 1, v.shape[1])).index_copy_(
            0, sl.orig_pad.long(), v_s)[:nq],
        "interp": whole,
        "brute": lambda: grid_knn._brute_interp(q, r, v, K, EPS),
    }
    owner = common.Owner()
    readings, profile = {}, {}
    bound = functools.partial(grid_knn.grid_knn_interpolate_layout, **knobs)
    with common.patched(grid_knn, "grid_knn_interpolate_layout", bound):
        for name, fn in stage_fns.items():
            capture.release()

            def body(ins, fn=fn):
                return [fn() for _ in range(chain)][-1]
            stub = _stub_kernel if name == "querypass_stub" \
                else grid_knn.grid_interp
            run = functools.partial(
                common.run_body, ("interp_stages", name, chain, repr(knobs)),
                body, {"q": q}, owner, dev)
            with common.patched(grid_knn, "grid_interp", stub):
                res = common.measure(run, reps, dev)
                if name == "interp" and dev.type == "cuda":
                    profile = common.device_kernels(run)
            per = [ms / chain for ms in res["ms"]]
            readings[name] = {"ms": statistics.median(per),
                              "spread": common.spread(per), "runs_ms": per,
                              "launches": {k: n / chain for k, n in
                                           res["launches"].items()}}
    capture.release()
    in_context = common.marginal(readings["querypass"]["runs_ms"],
                                 readings["querypass_stub"]["runs_ms"])
    card = common.device_name(dev)
    print(f"{tag} one call at {nq}x{M} k={K} grid={gs} tq={tq} slot_cap={cap}"
          f" fallback_cap={fb} full_z={full_z} ({card}), {chain} calls a "
          f"body, median of {reps}: "
          + ", ".join(f"{n} {r_['ms']:.4f} ms (spread "
                      f"{100 * r_['spread']:.1f}%)"
                      for n, r_ in readings.items())
          + "; kernel in context (querypass - stubbed) "
          + common.marginal_note(in_context) + "; "
          f"{n_unsafe} unsafe rows of {nq}", flush=True)
    if profile:
        common.print_kernels(tag, "one replay of the whole call x"
                             f"{chain}", profile, card)
    return {"device": card, "queries": nq, "refs": M, "knobs": knobs,
            "full_z": full_z, "unsafe_rows": n_unsafe, "stages": readings,
            "kernel_in_context": in_context, "profile": profile or None}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--queries", type=int, default=90000)
    parser.add_argument("--refs", type=int, default=30000)
    parser.add_argument("--chain", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(common.SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, r, v = (randn(args.queries, 3) * 0.9, randn(args.refs, 3) * 0.9,
               randn(args.refs, 3))
    return stages(q, r, v, args.chain, args.reps)


if __name__ == "__main__":
    main()
