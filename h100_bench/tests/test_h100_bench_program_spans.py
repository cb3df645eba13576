"""The readers of the program's spans and unsafe-row counter
(``core/program_spans.py``, ``metrics/step_*``, ``*_ms.train``,
``replay_launch_ms.*``, ``grid_unsafe_pct.serve``) on a synthetic span log
and synthetic counts: their arithmetic, the replayed calls alone, and None
where the cell has no such span."""

import collections
import time

import pytest
import torch

from h100_bench.core import harness, program_spans
from pointcloud_style_transfer_torch.ops import grid_knn
from pointcloud_style_transfer_torch.utils.profiling import Span

BENCH = harness.load_benchmark()
NEW = ["step_ms.serve", "step_partition_ms.serve", "step_denoiser_ms.serve",
       "step_upsample_ms.serve", "grid_unsafe_pct.serve",
       "replay_launch_ms.serve", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train", "replay_launch_ms.train"]


def run_of(cell, spans=None):
    """A run whose stretches both logged ``spans``."""
    run = harness.Run(harness.find_cell(BENCH, cell), 5, 1.0, True,
                      torch.device("cpu"), time.perf_counter())
    if spans is not None:
        run.state[program_spans.KEY] = {"host": spans, "device": spans}
    return run


class Log:
    """Spans of calls, each made by ``call(branch, {name: [ms, ...]})``."""

    def __init__(self):
        self.spans, self.ids, self.calls = [], 0, 0

    def span(self, name, call, parent, clock, ms):
        self.ids += 1
        self.spans.append(Span(self.ids, name, call, parent, clock, 0,
                               round(ms * 1e6)))
        return self.ids

    def call(self, branch, device, launch_ms=1.0):
        self.calls += 1
        c = self.calls
        self.span("capture.key", c, None, "host", 0.5)
        if branch == "capture":
            self.span("capture.capture", c, None, "host", 900.0)
        if branch == "eager":
            parent = self.span("capture.eager", c, None, "host", 800.0)
        else:
            parent = self.span("capture.replay", c, None, "host", launch_ms)
        for step in device:
            sid = self.span(step[0], c, parent, "device", step[1])
            for name, ms in step[2:]:
                self.span(name, c, sid, "device", ms)
        return self


def hier_step(k):
    return ("sampler.step", 2.0 + k, ("sampler.partition", 0.25),
            ("sampler.denoiser", 1.25 + k), ("sampler.upsample", 0.5))


def read(name, run):
    return harness.reader(name)(run)


def test_serve_readers_take_the_replayed_calls_alone():
    log = Log()
    log.call("eager", [hier_step(50)])  # eager and capture calls: left out
    log.call("capture", [hier_step(50)], launch_ms=70.0)
    log.call("replay", [hier_step(0), hier_step(1)], launch_ms=3.0)
    log.call("replay", [hier_step(2), hier_step(3)], launch_ms=5.0)
    run = run_of("serve-hier-b1", log.spans)
    assert read("step_ms.serve", run) == pytest.approx(3.5)
    assert read("step_partition_ms.serve", run) == pytest.approx(0.25)
    assert read("step_denoiser_ms.serve", run) == pytest.approx(2.75)
    assert read("step_upsample_ms.serve", run) == pytest.approx(0.5)
    assert read("replay_launch_ms.serve", run) == pytest.approx(4.0)


def test_direct_cell_has_no_partition_or_upsample():
    log = Log()
    for _ in range(2):
        log.call("replay", [("sampler.step", 5.0, ("sampler.denoiser", 4.5))])
    run = run_of("serve-direct-b1", log.spans)
    assert read("step_ms.serve", run) == pytest.approx(5.0)
    assert read("step_denoiser_ms.serve", run) == pytest.approx(4.5)
    assert read("step_partition_ms.serve", run) is None
    assert read("step_upsample_ms.serve", run) is None


def test_train_readers():
    log = Log()
    step = [("train.forward", 8.0), ("train.backward", 11.0),
            ("train.optimizer", 1.0)]
    log.call("replay", step, launch_ms=0.25)
    log.call("replay", [(n, 2 * ms) for n, ms in step], launch_ms=0.75)
    run = run_of("train-hier-b4", log.spans)
    assert read("forward_ms.train", run) == pytest.approx(12.0)
    assert read("backward_ms.train", run) == pytest.approx(16.5)
    assert read("optimizer_ms.train", run) == pytest.approx(1.5)
    assert read("replay_launch_ms.train", run) == pytest.approx(0.5)
    assert read("step_ms.serve", run) is None


def test_each_clock_reads_its_own_stretch():
    """Launch times from the stretch with the host's spans alone (the
    serving graph), stage times from the recording one."""
    host = Log().call("replay", [], launch_ms=2.0)
    device = Log().call("replay", [hier_step(0)], launch_ms=9.0)
    run = run_of("serve-hier-b1")
    run.state[program_spans.KEY] = {"host": host.spans,
                                    "device": device.spans}
    assert read("replay_launch_ms.serve", run) == pytest.approx(2.0)
    assert read("step_ms.serve", run) == pytest.approx(2.0)
    run.state[program_spans.KEY] = {"host": [], "device": device.spans}
    assert read("replay_launch_ms.serve", run) is None


@pytest.mark.parametrize("spans", [None, []])
def test_no_log_or_no_replayed_call_reads_none(spans):
    log = Log()
    log.call("eager", [hier_step(0)])
    log.call("capture", [hier_step(0)])
    for given in (spans, log.spans):
        run = run_of("serve-hier-b1", given)
        run.state.setdefault(program_spans.KEY, None)
        for name in NEW:
            if name != "grid_unsafe_pct.serve":
                assert read(name, run) is None, name


def test_the_four_card_mix_records_nothing():
    run = run_of("serve-hier-b1-points4")
    assert program_spans.log(run) is None
    assert run.state[program_spans.KEY] is None


def test_grid_unsafe_share(monkeypatch):
    counts = collections.deque([torch.tensor(n) for n in (900, 1800, 2700)],
                               maxlen=4096)
    monkeypatch.setattr(grid_knn, "UNSAFE_COUNTS", counts)
    run = run_of("serve-hier-b1")
    rows = 120_000 - 30_000
    assert read("grid_unsafe_pct.serve", run) == pytest.approx(
        100.0 * 5400 / (3 * rows))
    assert read("grid_unsafe_pct.serve", run_of("serve-direct-b1")) is None
    assert read("grid_unsafe_pct.serve", run_of("train-hier-b4")) is None
    counts.clear()
    assert read("grid_unsafe_pct.serve", run) is None


def test_each_new_metric_lists_its_cells():
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-len(NEW):] == NEW  # after the readers that were there
    for name in NEW:
        assert by_name[name]["source"] in ("program_span", "program_counter")
        assert "serve-hier-b1-points4" not in by_name[name]["workloads"]
