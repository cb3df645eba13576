"""Stage costs of the kd-grid's kNN mode on the PyTorch port (the call
``knn(backend="grid")`` and ``--fast`` make): the counterpart of
``examples/profile_grid_knn.py``, at its geometry (90,112 queries, 30,000
refs, k = 3; Gaussian clouds x 0.9) and the grid's defaults or the
environment knobs:

  core       ``_grid_knn_core``: the structure build and one query pass
             (layout, ``grid_topk``, margins, the query-order gathers),
             no fallback; and its unsafe rows;
  structure  ``_build_ref_structure`` (the z sort skipped where whole
             columns fit, as the core skips it);
  layout     ``_layout_slots``: cell assignment, the padded layout, the
             slot tables (the JAX script's ``_layout_queries``);
  kernel     ``grid_topk`` alone on that layout;
  unsort     the layout-to-query map (one scatter) and the distances
             gathered through it;
  order_r    the sorted-position to ref-id gather of the kernel's ids;
  plumbing   ``_grid_knn_core`` with ``grid_topk`` stubbed to zeros of its
             shapes; core - plumbing is the kernel in context (unresolved
             within either one's spread, ``profile_common_torch.marginal``);
  full       ``_grid_knn_single``: the core and its fallback ladder (the
             counted brute-force patch).

Each stage runs ``--chain`` times (10) in one body, each call's queries
fed from the one before; on the card the body is one CUDA graph replayed
``--reps`` times (5) between CUDA events, ms a call the median replay /
the chain. ``stages`` takes given clouds and grid keywords.

Usage: python examples/profile_grid_knn_torch.py [--queries 90112]
           [--refs 30000] [--chain 10] [--reps 5] [--device cuda|cpu]
Env knobs: PCST_PROF_GRID, PCST_PROF_TQ, PCST_PROF_SLOT_CAP (and the
others of ``profile_common_torch.grid_knobs``).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.ops import grid_knn  # noqa: E402

K = 3


def _stub_topk(q_pad, refs_sorted, st, en, k, n_real=None):
    """``grid_topk``'s outputs at its shapes, with no scan."""
    NP = q_pad.shape[0]
    return (q_pad.new_zeros((NP, k)),
            torch.zeros((NP, k), dtype=torch.int32, device=q_pad.device))


def stages(q: torch.Tensor, r: torch.Tensor, chain: int = 10, reps: int = 5,
           knobs: dict | None = None) -> dict:
    """Each stage of one cloud's grid kNN (query [Nq, 3], ref [M, 3] on one
    device), ``chain`` times a body, timed by ``common.timed_body``, and
    printed. Returns the readings, the core's unsafe rows and ``full``'s
    (d, i)."""
    knobs = dict(knobs or common.grid_knobs())
    gs, tq, cap, fb = (tuple(knobs["grid_shape"]), knobs["tq"],
                       knobs["slot_cap"], knobs["fallback_cap"])
    zh, xy = knobs["z_halo"], knobs["xy_halo"]
    dev = q.device
    nq, M = q.shape[0], r.shape[0]
    full_z = grid_knn._full_z_ok(M, gs, cap)
    struct = grid_knn._build_struct(r, gs, skip_z_sort=full_z)
    sl = grid_knn._layout_slots(struct, q, gs, tq, cap, zh, xy)
    d_s, gidx = grid_knn.grid_topk(sl.q_pad, struct.refs_pad, sl.st, sl.en,
                                   K, sl.n_real)
    gidx = gidx.long()

    def core(qq):
        return grid_knn._grid_knn_core(qq, r, K, gs, tq, cap, zh,
                                       xy_halo=xy)

    def unsort():
        posq = sl.orig_pad.new_empty(nq + 1).scatter_(
            0, sl.orig_pad, torch.arange(sl.orig_pad.shape[0], device=dev))
        return d_s[posq[:nq]]
    stage_fns = {
        "core": lambda qq: core(qq)[0],
        "structure": lambda qq: grid_knn._build_ref_structure(
            r + qq[:1, :1] * 0.0, gs, skip_z_sort=full_z)[0],
        "layout": lambda qq: grid_knn._layout_slots(
            struct, qq, gs, tq, cap, zh, xy).q_pad[:, :K],
        "kernel": lambda qq: grid_knn.grid_topk(
            sl.q_pad + qq[:1, :1] * 0.0, struct.refs_pad, sl.st, sl.en, K,
            sl.n_real)[0],
        "unsort": lambda qq: unsort() + qq[:1, :1] * 0.0,
        "order_r": lambda qq: torch.where(
            gidx < M, struct.order_r[gidx.clamp(0, M - 1)], 0).float()
        + qq[:1, :1] * 0.0,
        "plumbing": lambda qq: core(qq)[0],
        "full": lambda qq: grid_knn._grid_knn_single(
            qq, r, K, gs, tq, cap, fb, zh, xy),
    }
    owner = common.Owner()
    readings, full_out = {}, None
    for name, fn in stage_fns.items():
        def body(ins, fn=fn):
            out = fn(ins["q"])
            for _ in range(chain - 1):
                d = out[0] if isinstance(out, tuple) else out
                out = fn(ins["q"] + d[:1, :1] * 0.0)
            return out
        stub = _stub_topk if name == "plumbing" else grid_knn.grid_topk
        with common.patched(grid_knn, "grid_topk", stub):
            readings[name] = common.timed_body(
                ("grid_knn_stages", name, chain, repr(knobs)), body,
                {"q": q}, owner, reps, dev, per=chain)
        first = readings[name].pop("first")
        if name == "full":
            full_out = first
    common.capture.release()
    unsafe = int(core(q)[2].sum())
    in_context = common.marginal(readings["core"]["runs_ms"],
                                 readings["plumbing"]["runs_ms"])
    card = common.device_name(dev)
    print(f"device={card}  Nq={nq} M={M} k={K} grid={gs} tq={tq} "
          f"slot_cap={cap} fallback_cap={fb} full_z={full_z}; {chain} calls "
          f"a body, median of {reps}")
    for name, rd in readings.items():
        print(f"  {name:10s} {rd['ms']:8.4f} ms a call (spread "
              f"{100 * rd['spread']:.1f}%); launches a call "
              f"{rd['launches']}")
    print(f"  unsafe rows: {unsafe} / {nq}; kernel in context (core - "
          f"plumbing) {common.marginal_note(in_context)}", flush=True)
    return {"device": card, "queries": nq, "refs": M, "knobs": knobs,
            "full_z": full_z, "unsafe_rows": unsafe, "stages": readings,
            "kernel_in_context": in_context, "full": full_out}


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--queries", type=int, default=90112)
    parser.add_argument("--refs", type=int, default=30000)
    parser.add_argument("--chain", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(common.SEED)
    q = torch.randn((args.queries, 3), generator=gen, device=dev) * 0.9
    r = torch.randn((args.refs, 3), generator=gen, device=dev) * 0.9
    return stages(q, r, args.chain, args.reps)


if __name__ == "__main__":
    main()
