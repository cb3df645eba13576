"""The readings a cell's limits are set from, many seeds in one process:

    python h100_bench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--fault half_batch]

For each seed it builds the cell as a run does (set-up with its warm-up
or first steps), serves the checked requests (serving cells) and reads:

* ``program``: the numbers the run's check compares, for the program;
* ``control`` (``--control``): the same numbers for the plain reference
  in float8 e4m3 (one scale a tensor, float32 sums) put in the program's
  place: the precision below the bfloat16 the configuration states;
* ``fault_<name>`` (``--fault``, a comma-separated list): training, the
  reference with a fault planted, in the program's place: ``half_batch``
  leaves out half of each batch and takes the mean over the rest,
  ``acc_unchanged`` leaves the accumulated gradient as it was from the
  third mini-step (the first replay) on, ``no_clip`` drops the clip by
  global norm; serving, the program with a fault planted:
  ``slice_dropped`` leaves the denoiser's noise at zero on a thirty-second
  of the interpolated points (a tile range the grid never wrote).

One JSON line a seed on standard output. Not run by the benchmark's own
runs; the chip's readings are in ``PERF.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from h100_bench.core import compare, harness  # noqa: E402


def slice_dropped(patch=setattr):
    """Plants in the program (through ``patch``): the upsampled noise of the
    first thirty-second of the interpolated points is left at zero at every
    step."""
    from pointcloud_style_transfer_torch.models import samplers
    upsample = samplers._upsample_unknown

    def faulty(x, idx, coarse_vals, *args, **kwargs):
        out = upsample(x, idx, coarse_vals, *args, **kwargs)
        unknown = samplers.complement_indices(idx, x.shape[1])
        rows = unknown[:, :max(1, unknown.shape[1] // 32)]
        return out.scatter(1, rows[..., None].expand(-1, -1, out.shape[2]),
                           0.0)
    patch(samplers, "_upsample_unknown", faulty)


def serve_readings(run, driver, control: bool, label: str = "program"
                   ) -> dict:
    n = run.cell.check["requests"]
    run.records = [driver.request(run, i) for i in range(n)]
    driver.release(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = driver.checked_pairs(run, controls=("fp8",) if control else ())
    out = {label: compare.serve_readings(pairs["program"])}
    if control:
        out["control"] = compare.serve_readings(pairs["fp8"])
    return out


def half_batch(driver, run, precision):
    """``reference_steps`` on the first half of each batch."""
    rows_of, draws_of = driver.rows_of, driver.draws_of
    B = run.cell.traffic["batch"]

    def rows(r, j):
        return rows_of(r, j)[:B // 2]

    def draws(r, j):
        d = draws_of(r, j)
        return {k: ([m[:B // 2] for m in v] if isinstance(v, list) else
                    v[:, :B // 2] if k == "fps_starts" else v[:B // 2])
                for k, v in d.items()}
    driver.rows_of, driver.draws_of = rows, draws
    try:
        return driver.reference_steps(run, precision)
    finally:
        driver.rows_of, driver.draws_of = rows_of, draws_of


def acc_unchanged(driver, run, precision):
    """``reference_steps`` whose accumulator keeps its value from the
    third mini-step on, as a replayed step whose gradients never land."""
    from h100_bench.reference import train as ref_train
    apply = ref_train.Trainer._apply

    def faulty(self, grads, lr):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls > 2:
            grads = dict(self.acc)
        apply(self, grads, lr)
    ref_train.Trainer._apply = faulty
    try:
        return driver.reference_steps(run, precision)
    finally:
        ref_train.Trainer._apply = apply


def no_clip(driver, run, precision):
    """``reference_steps`` with no clip by global norm."""
    cfg = run.cell.config
    run.cell.config = {**cfg, "gradient_clip": float("inf")}
    try:
        return driver.reference_steps(run, precision)
    finally:
        run.cell.config = cfg


TRAIN_FAULTS = {"half_batch": half_batch, "acc_unchanged": acc_unchanged,
                "no_clip": no_clip}


def train_readings(run, driver, control: bool, faults=()) -> dict:
    driver.release(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = driver.reference_steps(run, "bf16")
    exact = driver.reference_steps(run, "fp32", steps=1)
    w, k = run.state["weights"], run.cell.config["gradient_accumulation_steps"]
    out = {"worst_leaves": {}}
    out["program"] = compare.train_readings(run.state["first"], ref, w,
                                            exact, k, out["worst_leaves"])
    if control:
        out["control"] = compare.train_readings(
            driver.reference_steps(run, "fp8"), ref, w, exact, k)
    for name in faults or ():
        out[f"fault_{name}"] = compare.train_readings(
            TRAIN_FAULTS[name](driver, run, "bf16"), ref, w, exact, k)
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="",
                   help="comma-separated: " + ", ".join(
                       [*TRAIN_FAULTS, "slice_dropped"]))
    args = p.parse_args(argv)
    faults = [f for f in args.fault.split(",") if f]
    harness.set_cache_dirs()
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    driver = harness.driver_of(cell)
    if "slice_dropped" in faults:
        slice_dropped()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, 0.0, False, torch.device("cuda", 0),
                          t0)
        driver.setup(run)
        if cell.traffic["driver"] == "train":
            out = train_readings(run, driver, args.control, faults)
        else:
            out = serve_readings(run, driver, args.control,
                                 "fault_slice_dropped" if faults else
                                 "program")
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
