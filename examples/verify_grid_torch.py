"""Full-size exactness check of the kd-grid on the card: the counterpart of
``examples/verify_grid_tpu.py``.

The CPU tests run the grid's plain twins (``ops/kernels/``), not the CUDA
kernels, and the card's float arithmetic is what ships: any change to the
grid pipeline (``ops/grid_knn.py``, ``csrc/grid_fused.cu``, the brute-force
patch) reruns this check on the card. Four gates at Nq x M (90,112 x
30,000, k = 3; Gaussian clouds x 0.9 from seeded generators):

  (1) kNN     ``knn(backend="grid")`` against ``knn(backend="pallas")``:
              the largest |d| difference exactly 0, index differences only
              where the distances tie exactly;
  (2) interp  ``grid_knn_interpolate`` against the brute kNN +
              inverse-distance oracle (numpy), < 5e-4;
  (3) layout  ``grid_knn_interpolate_layout`` put back by its query ids: a
              complete permutation, within 1e-6 of (2)'s output;
  (4) batched ``grid_knn_interpolate_layout_batched`` on four clouds at
              scales 0.5 / 0.9 / 1.8 / 3.0 against the one-cloud entry
              point (<= 1e-6) and the oracle (< 5e-4), where
              ``_batched_grid_ok`` holds; else reported skipped.

Each gate prints an ``EXACTNESS (...): OK/FAILED`` line; ``main`` returns
each gate's figures and ``ok``, and the script exits 1 when a gate failed.

Usage: python examples/verify_grid_torch.py [Nq] [M] [k] [--device cuda|cpu]
Env knobs: PCST_PROF_GRID, PCST_PROF_TQ, PCST_PROF_SLOT_CAP,
PCST_PROF_FALLBACK_CAP, PCST_PROF_Z_HALO, PCST_PROF_XY_HALO
(``profile_common_torch.grid_knobs``, the production grid by default),
bound to the grid's entry points.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.ops import grid_knn, knn  # noqa: E402

SCALES = (0.5, 0.9, 1.8, 3.0)  # gate 4's clouds
INTERP_BAR = 5e-4  # the interpolation against the oracle
LAYOUT_BAR = 1e-6  # a layout-order output against the query-order one


def oracle(d: np.ndarray, i: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The inverse-distance interpolation of one cloud from its brute kNN
    (d, i [Nq, k]) and values v [M, C], in numpy float32."""
    w = 1.0 / (np.sqrt(np.maximum(d, 0.0)) + 1e-8)
    w = w / w.sum(-1, keepdims=True)
    return (v[i] * w[..., None]).sum(1)


def assembled(v_lay: np.ndarray, qid: np.ndarray, n: int
              ) -> tuple[np.ndarray, bool]:
    """Layout rows put back at their query ids ([n, C]) and whether the
    real rows' ids are each of 0..n-1 once."""
    real = qid < n
    perm_ok = bool(np.array_equal(np.sort(qid[real]), np.arange(n)))
    out = np.zeros((n, v_lay.shape[1]), np.float32)
    out[qid[real]] = v_lay[real]
    return out, perm_ok


def report(name: str, ok: bool) -> None:
    print(f"EXACTNESS ({name}):", "OK" if ok else "FAILED", flush=True)


def gates(nq: int, m: int, k: int, dev: torch.device, knobs: dict) -> dict:
    """The four gates; each a dict of its figures and ``ok``."""
    def randn(seed, *shape):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    g0 = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, nq, 3), generator=g0, device=dev) * 0.9
    r = torch.randn((1, m, 3), generator=g0, device=dev) * 0.9
    out = {}

    d_g, i_g = knn(q, r, k, backend="grid")
    d_b, i_b = knn(q, r, k, backend="pallas")
    d_g, i_g, d_b, i_b = map(np_, (d_g, i_g, d_b, i_b))
    diff = np.abs(d_g - d_b)
    mism = i_g != i_b
    at_mism = float(diff[mism].max()) if mism.any() else 0.0
    out["knn"] = {"max_d_diff": float(diff.max()),
                  "idx_mismatches": int(mism.sum()), "of": int(i_g.size),
                  "d_diff_at_mismatches": at_mism,
                  "ok": float(diff.max()) == 0.0 and at_mism == 0.0}
    print(f"max |d| diff: {out['knn']['max_d_diff']}")
    print(f"idx mismatches: {int(mism.sum())} of {i_g.size}"
          + (f" (d diff there: {at_mism})" if mism.any() else ""))
    report("kNN", out["knn"]["ok"])

    v = randn(7, 1, m, 3)
    got = np_(grid_knn.grid_knn_interpolate(q, r, v, k))
    want = oracle(d_b[0], i_b[0], np_(v)[0])[None]
    verr = float(np.abs(got - want).max())
    out["interp"] = {"max_err": verr, "bar": INTERP_BAR,
                     "ok": verr < INTERP_BAR}
    print(f"interp max |v| err: {verr}")
    report("interp", out["interp"]["ok"])

    v_lay, qid = grid_knn.grid_knn_interpolate_layout(q[0], r[0], v[0], k)
    lay, perm_ok = assembled(np_(v_lay), np_(qid), nq)
    lerr = float(np.abs(lay - got[0]).max())
    out["layout"] = {"max_diff": lerr, "perm_ok": perm_ok, "bar": LAYOUT_BAR,
                     "ok": perm_ok and lerr <= LAYOUT_BAR}
    print(f"layout-composed max |v| diff vs interp: {lerr} "
          f"(perm {'OK' if perm_ok else 'BAD'})")
    report("layout", out["layout"]["ok"])

    B = len(SCALES)
    g11 = torch.Generator(device=dev).manual_seed(11)
    scales = torch.tensor(SCALES, device=dev)[:, None, None]
    qb = torch.randn((B, nq, 3), generator=g11, device=dev) * scales
    rb = torch.randn((B, m, 3), generator=g11, device=dev) * scales
    vb = randn(13, B, m, 3)
    if grid_knn._batched_grid_ok(B, nq, m, knobs["grid_shape"],
                                 knobs["slot_cap"], k):
        vb_lay, qidb = grid_knn.grid_knn_interpolate_layout_batched(
            qb, rb, vb, k)
        asm, permb_ok = assembled(np_(vb_lay), np_(qidb), B * nq)
        asm = asm.reshape(B, nq, -1)
        per = np.concatenate([np_(grid_knn.grid_knn_interpolate(
            qb[j:j + 1], rb[j:j + 1], vb[j:j + 1], k)) for j in range(B)])
        d2, i2 = map(np_, knn(qb, rb, k, backend="pallas"))
        wantb = np.stack([oracle(d2[j], i2[j], np_(vb)[j])
                          for j in range(B)])
        berr = float(np.abs(asm - per).max())
        oerr = float(np.abs(asm - wantb).max())
        out["batched"] = {
            "skipped": False, "B": B, "max_diff_per_cloud": berr,
            "max_err_oracle": oerr, "perm_ok": permb_ok,
            "ok": permb_ok and berr <= LAYOUT_BAR and oerr < INTERP_BAR}
        print(f"batched(B={B}) max |v| diff vs per-cloud: {berr}, vs "
              f"oracle: {oerr} (perm {'OK' if permb_ok else 'BAD'})")
    else:
        out["batched"] = {"skipped": True, "B": B, "ok": True}
        print(f"batched path not applicable at (Nq={nq}, M={m}) - skipped")
    report("batched", out["batched"]["ok"])
    return out


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*", type=int, help="[Nq] [M] [k]")
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    a = args.args
    nq = a[0] if len(a) > 0 else 90112
    m = a[1] if len(a) > 1 else 30000
    k = a[2] if len(a) > 2 else 3
    dev = resolve_device(args.device)
    knobs = common.grid_knobs()
    print(f"device={common.device_name(dev)}  Nq={nq} M={m} k={k} "
          f"grid={knobs}")
    with common.grid_bound(knobs):
        out = gates(nq, m, k, dev, knobs)
    return {"device": common.device_name(dev), "nq": nq, "m": m, "k": k,
            "knobs": knobs, "gates": out,
            "ok": all(g["ok"] for g in out.values())}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
