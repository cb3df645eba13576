"""The numbers that decide ``correct``: each is compared with its limit in
``workloads/<cell>.json`` (``limits``), and the run is correct when every
one is at or under its limit.

Serving: a request's answer against the float32 reference's, point by
point, in the source's normalised frame (coordinates within +-1.8). The
50-step sampler is chaotic: a voxel representative or a third neighbour
that flips on rounding moves its point, and the points it moves move
others, so two honest runs at the configuration's bfloat16 end apart by an
amount that changes from seed to seed. The reference is therefore also run
with bfloat16 rounding (the floor), and the compared number is the ratio
of the program's median point distance to the floor's, each from the
float32 reference: about 1 for any sound run, whatever the seed, and
several times that for a lower precision or a wrong step. The same ratio of
the 99th percentiles sees a fault that moves a few percent of the points
far, which leaves the median as it was.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def point_errors(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Euclidean distance of each point of ``got`` [N, 3] from ``want``'s;
    a point that is not finite counts as infinitely far."""
    d = np.linalg.norm(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64), axis=1)
    return np.where(np.isfinite(d), d, np.inf)


def serve_readings(pairs: List[Tuple[np.ndarray, np.ndarray]]
                   ) -> Dict[str, float]:
    """Over the compared answers, each given with its request's floor (the
    bfloat16 reference's point distances), the worst of each statistic."""
    out = {}
    for name, q in (("median", 50), ("p90", 90), ("p99", 99)):
        out[f"{name}_err_ratio"] = max(
            float(np.percentile(e, q) / max(np.percentile(f, q), 1e-12))
            for e, f in pairs)
    out["median_point_err"] = max(float(np.median(e)) for e, _ in pairs)
    out["floor_median_point_err"] = max(float(np.median(f))
                                        for _, f in pairs)
    out["floor_p99_point_err"] = max(float(np.percentile(f, 99))
                                     for _, f in pairs)
    return out


def numbers(readings: Dict[str, float], limits: Dict[str, float]
            ) -> List[dict]:
    """The compared numbers, each with its limit, in the limits' order;
    the other readings are printed but not compared."""
    import sys
    for name, value in readings.items():
        if name not in limits:
            print(f"reading {name} = {value!r}", file=sys.stderr)
    return [{"name": name, "value": float(readings[name]),
             "limit": float(limit)} for name, limit in limits.items()]


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float]
               ) -> Dict[str, float]:
    """Each leaf's gap of norms, |got - want|, over the larger of its
    reference norm and the median leaf's (some leaves are all but zero)."""
    floor = float(np.median(list(want.values())))
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in want}


def _norms(tensors, names) -> Dict[str, float]:
    return {k: float(np.linalg.norm(
        tensors[k].detach().double().cpu().numpy().ravel())) for k in names}


def train_readings(prog: dict, ref: dict, start: dict, exact: dict,
                   every_k: int, details: dict = None) -> Dict[str, float]:
    """Training: the program's first steps against the reference's at the
    configuration's precision (``ref``), from the same weights ``start``.

    * ``noise_loss_gap``, ``chamfer_loss_gap``, ``total_loss_gap``: the
      largest relative gap of that loss term over the first optimizer
      step's ``every_k`` mini-steps, which start from the same weights;
      ``<name>_all``, the same over every step: after an optimizer step the
      two sides' weights differ by Adam's sign-like first update on
      gradients that are nought to rounding, noise of the later steps;
    * ``grad_gap``: the first optimizer step's gradient as the optimizer
      holds it (the accumulated mean, clipped), worked out from its first
      moment and from its second, the worst leaf's gap of norms over both;
    * ``acc_gap``: the second optimizer step's accumulated gradient before
      its last mini-step, unclipped, the worst leaf's gap of norms;
    * ``change_gap`` / ``ema_gap``: the parameters' and the EMA's change
      over the steps, the worst leaf's gap of norms;
    * ``<name>_median`` for each of the four above: the median leaf's gap,
      steady from seed to seed where the worst leaf's is one small leaf's
      noise.

    Leaves whose first gradient in the float32 reference (``exact``) is
    under a thousandth of the median leaf's are left out of all of them: a
    bias before BatchNorm in train mode has a gradient that is nought up to
    rounding (the mean the normalisation takes out), which bfloat16 makes
    a sizeable noise, and Adam moves it by that noise's sign.

    ``details``, a dict, gets the worst leaf of each comparison."""
    out: Dict[str, float] = {}
    for term in ref["terms"][0]:
        gaps = [abs(p[term] - r[term]) / max(abs(r[term]), 1e-30)
                for p, r in zip(prog["terms"], ref["terms"])]
        out[f"{term.split('_')[0]}_loss_gap"] = max(gaps[:every_k])
        out[f"{term.split('_')[0]}_loss_gap_all"] = max(gaps)
    names = list(exact["step_grad"])
    g_exact = _norms(exact["step_grad"], names)
    floor = float(np.median(list(g_exact.values())))
    moved = [k for k in names if g_exact[k] >= 1e-3 * floor]

    def change(src: dict, key: str) -> dict:
        return {k: src[key][k].detach().float().cpu()
                - start[k].detach().float().cpu() for k in moved}
    compared = {
        "grad": [(prog["grad"], ref["grad"]),
                 (prog["grad_nu"], ref["grad_nu"])],
        "acc": [(prog["acc"], ref["acc"])],
        "change": [(change(prog, "params"), change(ref, "params"))],
        "ema": [(change(prog, "ema"), change(ref, "ema"))]}
    worst = {}
    for name, pairs in compared.items():
        per = [_leaf_gaps(_norms(got, moved), _norms(want, moved))
               for got, want in pairs]
        gaps = {k: max(g[k] for g in per) for k in moved}
        out[f"{name}_gap"] = max(gaps.values())
        out[f"{name}_gap_median"] = max(float(np.median(list(g.values())))
                                        for g in per)
        worst[name] = max(gaps, key=gaps.get)
    out["left_out_leaves"] = float(len(names) - len(moved))
    out["reference_first_acc_norm"] = float(ref["acc_norms"][0])
    if details is not None:
        details.update(worst)
    return out
