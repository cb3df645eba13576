"""The flat-batched grid interpolation against cloud by cloud at the
sampler's geometry on the PyTorch port: the counterpart of
``examples/profile_batched_interp.py``. For each B (1 and 4 by default),
B clouds of 90,112 queries and 30,000 refs (Gaussian x 0.9, k = 3), three
variants:

  flat       ``grid_knn_interpolate``: at B > 1 flat-batched (one build,
             one layout, one ``grid_interp`` launch and one fallback ladder
             for every cloud, ``_batched_grid_ok``);
  percloud   ``_grid_interp_single`` cloud after cloud (the JAX script's
             ``lax.map``);
  flat_nofb  ``_build_struct_batched`` + ``_query_pass(...,
             layout_out=True)``: the flat pass with no fallback ladder
             (inexact on unsafe rows: it isolates the ladder's cost).

Each variant runs ``--chain`` times (10) in one body, each call's queries
moved by the one before (a scalar x 1e-20) and by 1e-7 a call; on the card
the body is one CUDA graph replayed ``--reps`` times (5) between CUDA
events. Prints ms a call and ms a cloud.

Usage: python examples/profile_batched_interp_torch.py [B ...] [--chain 10]
           [--reps 5] [--queries 90112] [--refs 30000] [--device cuda|cpu]
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
from pointcloud_style_transfer_torch.ops import grid_knn  # noqa: E402

K = 3
EPS = 1e-8
VARIANTS = ("flat", "percloud", "flat_nofb")


def variants(knobs: dict) -> dict:
    """Each variant's call on (q [B, Nq, 3], r [B, M, 3], v [B, M, C])."""
    gs, tq, cap, fb = (tuple(knobs["grid_shape"]), knobs["tq"],
                       knobs["slot_cap"], knobs["fallback_cap"])
    zh, xy = knobs["z_halo"], knobs["xy_halo"]

    def flat_nofb(q, r, v):
        structb = grid_knn._build_struct_batched(r.float(), gs)
        return grid_knn._query_pass(structb, q, K, gs, tq, cap, xy_halo=xy,
                                    values=v, eps=EPS, layout_out=True)[0]
    return {
        "flat": lambda q, r, v: grid_knn.grid_knn_interpolate(q, r, v, K),
        "percloud": lambda q, r, v: torch.stack([
            grid_knn._grid_interp_single(qb, rb, vb, K, gs, tq, cap, fb, zh,
                                         EPS, xy, False)
            for qb, rb, vb in zip(q, r, v)]),
        "flat_nofb": flat_nofb}


def chained(call, chain: int):
    """The body: ``chain`` calls, each on queries moved by the sum of the
    one before x 1e-20 and by 1e-7 a call; returns the first call's
    output and the sum."""
    def body(ins):
        q, r, v = ins["q"], ins["r"], ins["v"]
        out = q.new_zeros(())
        first = None
        for i in range(chain):
            res = call(q + out * 1e-20 + i * 1e-7, r, v)
            first = res if first is None else first
            out = out + res[..., 0, :].sum()
        return first, out
    return body


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("batches", nargs="*", type=int, default=[1, 4])
    parser.add_argument("--chain", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--queries", type=int, default=90112)
    parser.add_argument("--refs", type=int, default=30000)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    card = common.device_name(dev)
    knobs = common.grid_knobs()
    calls = variants(knobs)
    print(f"device={card}  Nq={args.queries} M={args.refs} k={K} "
          f"chain={args.chain} grid={knobs}")
    owner = common.Owner()
    by_batch = {}
    with common.grid_bound(knobs):
        for B in args.batches:
            gen = torch.Generator(device=dev).manual_seed(common.SEED)
            ins = {"q": torch.randn((B, args.queries, 3), generator=gen,
                                    device=dev) * 0.9,
                   "r": torch.randn((B, args.refs, 3), generator=gen,
                                    device=dev) * 0.9,
                   "v": torch.randn((B, args.refs, 3), generator=gen,
                                    device=dev)}
            flat_ok = grid_knn._batched_grid_ok(
                B, args.queries, args.refs, knobs["grid_shape"],
                knobs["slot_cap"], K)
            by_batch[B] = {"flat_batched": flat_ok}
            for name in VARIANTS:
                rd = common.timed_body(
                    ("batched_interp", name, B, args.chain, repr(knobs)),
                    chained(calls[name], args.chain), ins, owner, args.reps,
                    dev, per=args.chain)
                rd["out"] = rd.pop("first")[0]
                rd["ms_per_cloud"] = rd["ms"] / B
                by_batch[B][name] = rd
                print(f"B={B} {name}: {rd['ms']:.4f} ms/call "
                      f"({rd['ms_per_cloud']:.4f} ms/cloud; spread "
                      f"{100 * rd['spread']:.1f}%), launches a call "
                      f"{rd['launches']}", flush=True)
    common.capture.release()
    return {"device": card, "knobs": knobs, "chain": args.chain,
            "by_batch": by_batch}


if __name__ == "__main__":
    main()
