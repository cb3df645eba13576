"""The kNN backends side by side at the sampler's geometry on the PyTorch
port: the counterpart of ``examples/bench_knn_backends.py``.

One [1, Nq, 3] x [1, M, 3] kNN (90,112 x 30,000, k = 3 by default;
Gaussian clouds x 0.9) through ``ops.distance.knn(backend=...)``, chained
``--chain`` times (10) in one body, each call's queries fed from the one
before (``q + d[..., :1] * 0``) so the calls run in order. On the card the
body is one CUDA graph (``models/capture.py``) replayed ``--reps`` times
(5) between CUDA events; ms a call is the median replay / the chain. With
``PCST_BENCH_FRESH_REFS=1`` each call's refs are perturbed by the one
before (``r + d[..., :1, :1] * 1e-12``), so that a backend's ref-side work
(the grid's build) is paid each call, as the sampler pays it each step.

A backend that raises is printed as ``FAILED`` and the run goes on;
``main`` returns it under ``failed`` (``chip_smoke.py`` fails on any).

Usage: python examples/bench_knn_backends_torch.py [Nq] [M] [k]
           [backend ...] [--chain 10] [--reps 5] [--device cuda|cpu]
Backends: ``pallas``, ``pallas_f32packed`` and ``grid`` by default, or any
of ``ops.distance.knn``'s (``pallas_pruned``, ``jnp``). Env knobs: the
grid's (``profile_common_torch.grid_knobs``), bound to its entry points.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.ops import knn  # noqa: E402

BACKENDS = ("pallas", "pallas_f32packed", "grid")


def chained(backend: str, k: int, chain: int, fresh_refs: bool):
    """The body: ``chain`` dependent calls; returns the first call's
    (d, i)."""
    def body(ins):
        q, r = ins["q"], ins["r"]
        first = d, _ = knn(q, r, k, backend=backend)
        for _ in range(chain - 1):
            if fresh_refs:
                r = r + d[..., :1, :1] * 1e-12
            d, _ = knn(q + d[..., :1] * 0.0, r, k, backend=backend)
        return first
    return body


def bench(backend: str, q: torch.Tensor, r: torch.Tensor, k: int,
          chain: int, reps: int, fresh_refs: bool) -> dict:
    """One backend's reading (``profile_common_torch.timed_body``, ms a
    call), and the first call's (d, i)."""
    owner = common.Owner()
    res = common.timed_body(("bench_knn", backend, k, chain, fresh_refs),
                            chained(backend, k, chain, fresh_refs),
                            {"q": q, "r": r}, owner, reps, q.device,
                            per=chain)
    d, i = res.pop("first")
    return {**res, "d": d, "i": i}


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*",
                        help="[Nq] [M] [k] [backend ...]")
    parser.add_argument("--chain", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    sizes = [int(a) for a in args.args[:3]]
    nq, m, k = sizes + [90112, 30000, 3][len(sizes):]
    backends = args.args[3:] or list(BACKENDS)
    fresh = os.environ.get("PCST_BENCH_FRESH_REFS") == "1"
    dev = resolve_device(args.device)
    card = common.device_name(dev)
    g = torch.Generator(device=dev).manual_seed(common.SEED)
    q = torch.randn((1, nq, 3), generator=g, device=dev) * 0.9
    r = torch.randn((1, m, 3), generator=g, device=dev) * 0.9
    print(f"device={card}  Nq={nq} M={m} k={k} chain={args.chain} "
          f"fresh_refs={fresh}")
    readings, failed = {}, {}
    with common.grid_bound(common.grid_knobs()):
        for b in backends:
            try:
                readings[b] = bench(b, q, r, k, args.chain, args.reps, fresh)
            except Exception as e:  # noqa: BLE001 - reported and returned
                failed[b] = f"{type(e).__name__}: {e}"
                print(f"{b:20s} FAILED: {failed[b]}", flush=True)
                continue
            rd = readings[b]
            print(f"{b:20s} {rd['ms']:8.4f} ms/call (best {rd['best_ms']:.4f}"
                  f", spread {100 * rd['spread']:.1f}%), launches a call "
                  f"{rd['launches']}", flush=True)
    return {"device": card, "nq": nq, "m": m, "k": k, "chain": args.chain,
            "fresh_refs": fresh, "backends": readings, "failed": failed}


if __name__ == "__main__":
    main()
