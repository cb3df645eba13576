"""Whole runs of the harness on the CPU at a tiny size (2,048-point clouds,
512 coarse points, a few steps): each traffic driver prints a well-formed
last line, a cell added as new files alone runs, a run loads no JAX, the
reference loads nothing of the program, and without a card a run fails
and prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench.core import harness

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_cell(name, root=ROOT, **traffic):
    cell = harness.find_cell(harness.load_benchmark(root), name, root)
    cell.config.update(total_points=2048, global_points=512)
    cell.traffic.update(pool_pairs=min(cell.traffic["pool_pairs"], 16),
                        trace_requests=1, trace_steps=2, **traffic)
    if "requests" in cell.check:
        cell.check["requests"] = 1
    return cell


def cell_limits(name):
    return harness.find_cell(harness.load_benchmark(), name).check["limits"]


def run_line(cell, trace, capsys, seconds=0.3):
    run = harness.Run(cell, 2 ** 40 + 3, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), chips=cell.chips)
    line = harness.execute(run, harness.driver_of(cell))
    assert harness.finish(line) == 0
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    parsed = json.loads(last)
    assert list(parsed)[:5] == KEYS and list(parsed)[-1] == "check"
    for name, n in parsed["check"].items():
        assert f"check {name} = " in out.err
    return parsed


def check_line(parsed, cell, trace):
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(parsed["metrics"]) <= names
    for name, m in parsed["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = parsed["device"]
    assert dev["count"] == cell.chips and dev["platform"] == "cpu"
    assert parsed["attempted"] >= 1 and parsed["failed"] == 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for key in ("device_ops", "idle_gaps"):
            rows = parsed["breakdown"][key]
            assert 1 <= len(rows) <= 10
            assert all(isinstance(n, str) and v >= 0 for n, v in rows)
    else:
        assert set(parsed["metrics"]) == names  # never left out


@pytest.mark.parametrize("trace", [0, 1])
def test_serve_driver_line(trace, capsys):
    cell = tiny_cell("serve-hier-b1", steps=3)
    check_line(run_line(cell, trace, capsys), cell, trace)


def test_serve_direct_line(capsys):
    cell = tiny_cell("serve-direct-b1", steps=3)
    check_line(run_line(cell, 0, capsys), cell, 0)


@pytest.mark.parametrize("trace", [0, 1])
def test_train_driver_line(trace, capsys):
    cell = tiny_cell("train-hier-b4")
    parsed = run_line(cell, trace, capsys, seconds=0.1)
    check_line(parsed, cell, trace)
    assert set(parsed["check"]) == set(cell.check["limits"])


def sharded_rank(rank, world, port, queue):
    """One gloo rank of a tiny {points: 2} run."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    cell = tiny_cell("serve-hier-b1-points4", steps=3, mesh={"points": world})
    run = harness.Run(cell, 17, 0.3, False, torch.device("cpu"),
                      time.perf_counter(), chips=cell.chips)
    run.state["rank"] = rank
    line = harness.execute(run, harness.driver_of(cell))
    queue.put((rank, line))


def collect(procs, queue, timeout=600.0):
    """Each rank's (rank, line) from ``queue``; fails as soon as a rank
    exits without one, and after ``timeout`` seconds."""
    import queue as queues
    got, deadline = {}, time.monotonic() + timeout
    while len(got) < len(procs):
        try:
            rank, line = queue.get(timeout=1.0)
            got[rank] = line
        except queues.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            assert not dead and time.monotonic() < deadline, dead
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    return got


def test_sharded_driver_line():
    import torch.multiprocessing as mp
    from h100_bench.drivers.serve_sharded import free_port
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    world, port = 2, free_port()
    procs = [ctx.Process(target=sharded_rank, args=(r, world, port, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = collect(procs, queue)
    assert got[1] is None  # only rank 0 reports
    line = got[0]
    assert list(line)[:5] == KEYS and line["correct"] in (True, False)
    assert line["device"]["count"] == 4  # the cell's cards, not the test's
    assert set(line["check"]) == set(cell_limits("serve-hier-b1-points4"))


def test_a_cell_added_as_files_alone_runs(tmp_path, capsys):
    """A new traffic mix and cell: two data files and a BENCHMARK.json
    entry, no edit to any file that is there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((ROOT / "h100_bench/traffic/serve-b1.json").read_text())
    mix.update(steps=5, guidance=3.0)
    (tmp_path / "h100_bench/traffic/serve-b1-g3.json").write_text(
        json.dumps(mix))
    (tmp_path / "h100_bench/workloads/serve-hier-g3.json").write_text(
        (ROOT / "h100_bench/workloads/serve-hier-b1.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "serve-hier-g3",
                               "config": "pcst-120k-hier",
                               "traffic": "serve-b1-g3", "chips": 1,
                               "why": "guidance 3"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve-hier-b1" in m.get("workloads", []):
            m["workloads"].append("serve-hier-g3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("serve-hier-g3", root=tmp_path)
    assert cell.traffic["guidance"] == 3.0
    check_line(run_line(cell, 0, capsys), cell, 0)


def run_py(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "h100_bench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_means_no_result():
    r = run_py(["--workload", "serve-hier-b1", "--seed", "1", "--seconds",
                "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(["--workload", "serve-hier-b1", "--seed", "1", "--seconds",
                "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from h100_bench.core import harness\n"
        "from h100_bench.tests.test_h100_bench_runs import tiny_cell\n"
        "cell = tiny_cell('serve-hier-b1', steps=2)\n"
        "run = harness.Run(cell, 5, 0.1, True, torch.device('cpu'), "
        "time.perf_counter())\n"
        "harness.execute(run, harness.driver_of(cell))\n"
        "cell = tiny_cell('train-hier-b4')\n"
        "run = harness.Run(cell, 5, 0.1, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "harness.execute(run, harness.driver_of(cell))\n"
        "print('FOUND', harness.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FOUND []" in r.stdout


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("jax_free_lookalike", sys)  # not "jax"
    try:
        assert "jax" not in harness.forbidden_modules()
        assert all(m not in ("jax_free_lookalike",
                             "pointcloud_style_transfer_torch")
                   for m in harness.forbidden_modules())
    finally:
        del sys.modules["jax_free_lookalike"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import h100_bench.reference.sampler, h100_bench.reference.train\n"
            "import h100_bench.reference.request\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pointcloud_style_transfer_torch', "
            "'pointcloud_style_transfer_tpu', 'jax')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
    for path in (ROOT / "h100_bench/reference").glob("*.py"):
        assert "pointcloud_style_transfer" not in path.read_text(), path
