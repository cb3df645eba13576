"""One run of one cell: read ``BENCHMARK.json``, find the cell's files by
name, set up the program, measure for ``--seconds``, optionally trace, check
the timed path's outputs against the plain reference, and print the result
as the last line of standard output.

What belongs to one cell, configuration, traffic mix or metric sits in
files of its own, found by name:

* ``configs/<config>.json`` -- the configuration's sizes (``file`` in
  ``BENCHMARK.json``);
* ``traffic/<traffic>.json`` -- the mix's parameters, among them
  ``driver``, which names ``drivers/<driver>.py``;
* ``workloads/<cell>.json`` -- the cell's correctness check: how many
  answers it compares and each number's limit;
* ``metrics/<metric>.py`` -- each metric's reader: ``read(run)`` returns a
  number, or None where the run holds nothing to read.

A later cell, configuration, mix or metric is therefore new files and new
entries, with no edit to a file that is here.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# what no process of a run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "pointcloud_style_transfer_tpu")


@dataclasses.dataclass
class Cell:
    """A cell's entries and files."""
    name: str
    entry: dict              # its ``workloads`` entry
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    check: dict              # workloads/<cell>.json
    end_to_end: List[dict]   # the end-to-end metrics it reports
    per_layer: List[dict]    # the per-layer metrics it reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


@dataclasses.dataclass
class Run:
    """What a run hands its metric readers and its check."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                               # torch.device
    t_start: float                            # the process's first clock
    setup_s: float = 0.0
    records: List[dict] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    trace_summary: Optional[Any] = None       # core.trace.Summary
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    chips: int = 1


def mark(run: Run, name: str) -> None:
    """Note the seconds since the process started at a point of set-up;
    printed with the phases on standard error."""
    run.state.setdefault("marks", []).append(
        (name, time.perf_counter() - run.t_start))


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files under ``root``."""
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    entry = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        check = json.load(f)

    def applies(metric: dict, e2e_names=None) -> bool:
        if "workloads" in metric:
            return name in metric["workloads"]
        if e2e_names is None:  # an end-to-end metric of every cell
            return True
        return metric["moves"] in e2e_names

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, names)]
    return Cell(name, entry, config, traffic, check, e2e, per_layer)


def driver_of(cell: Cell):
    return importlib.import_module(
        f"h100_bench.drivers.{cell.traffic['driver']}")


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["PCST_TORCH_KERNEL_CACHE"] = str(build / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell, started by its driver
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def metric_values(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(run: Run, driver) -> Optional[dict]:
    """Set-up, window, trace, check: the result line's fields, or None on
    a rank that does not report."""
    import torch
    mark(run, "imported")
    driver.setup(run)
    run.setup_s = time.perf_counter() - run.t_start
    phases = {"setup_s": run.setup_s}
    t = time.perf_counter()
    driver.window(run)
    phases["window_s"] = time.perf_counter() - t
    if run.device.type == "cuda":
        peak = driver.memory_peak(run) if hasattr(driver, "memory_peak") \
            else torch.cuda.max_memory_allocated(run.device)
    else:
        peak = 0
    breakdown = None
    t = time.perf_counter()
    if run.trace:
        driver.trace(run)
    cell = run.cell
    metrics = metric_values(run, cell.per_layer if run.trace
                            else cell.end_to_end)
    phases["trace_and_readers_s"] = time.perf_counter() - t
    driver.release(run)
    t = time.perf_counter()
    numbers = driver.check(run)
    phases["check_s"] = time.perf_counter() - t
    print("phases " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    print("set-up marks " + " ".join(
        f"{k}@{v:.3f}" for k, v in run.state.get("marks", [])),
        file=sys.stderr)
    reporting = getattr(driver, "reports", lambda r: True)(run)
    if not reporting:
        return None
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": run.chips, "memory_peak_bytes": int(peak)}
    if run.trace and run.trace_summary is not None:
        s = run.trace_summary
        device["busy_s"] = s.busy_s if s.all_busy_s is None else s.all_busy_s
        device["window_s"] = (s.window_s if s.all_window_s is None
                              else s.all_window_s)
        breakdown = s.breakdown
    correct = all(n["value"] <= n["limit"] for n in numbers) and \
        run.failed == 0 and len(numbers) > 0
    line = {"correct": bool(correct), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                     for n in numbers}
    return line


def finish(line: dict) -> int:
    """The forbidden-module check, then the compared numbers on standard
    error and the result as the last line of standard output."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, n in line["check"].items():
        print(f"check {name} = {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    cell = find_cell(load_benchmark(), args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    driver = driver_of(cell)
    if cell.chips > 1 and args.rank is None:
        return driver.launch(args, cell, t_start)
    rank = args.rank or 0
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", rank), t_start, chips=cell.chips)
    run.state["rank"] = rank
    torch.cuda.set_device(run.device)
    line = execute(run, driver)
    if line is None:
        return 0 if not forbidden_modules() else 3
    return finish(line)
