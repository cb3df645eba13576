"""The capture runner's choices (``models.capture.run_captured``), with its
eager run and its capture replaced by CPU stand-ins: a key's first call
runs eagerly, its second captures and replays, later ones replay; a new
owner is seen anew; a replay adds its graph's launches to
``LAUNCH_COUNTS`` and its unsafe counts to ``UNSAFE_COUNTS``. While spans
are recorded (``utils.profiling``) with the device's a key is another key
(with the host's alone it is not), and the runner's ``capture.*`` spans
share each call's id; the benchmark's trace reduction puts the host's time
in a call down to them. The CUDA graph itself is held on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``'s ``[graph]``)."""

import time

import pytest
import torch

from h100_bench.core import trace as bench_trace

from pointcloud_style_transfer_torch.models import capture
from pointcloud_style_transfer_torch.ops import grid_knn
from pointcloud_style_transfer_torch.ops.kernels import LAUNCH_COUNTS
from pointcloud_style_transfer_torch.utils import profiling


class Owner:
    pass


class FakeGraph:
    """Replays ``body`` on the static inputs into the static output."""

    def __init__(self, body, static, output):
        self.body, self.static, self.output = body, static, output
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.output.copy_(self.body(self.static))


@pytest.fixture
def runner(monkeypatch):
    calls = {"eager": 0, "capture": 0}
    monkeypatch.setattr(capture, "_ENTRIES", type(capture._ENTRIES)())

    def eager(body, inputs):
        calls["eager"] += 1
        return body(inputs)

    def fake_capture(body, inputs):
        calls["capture"] += 1
        static = {n: t.clone() for n, t in inputs.items()}
        output = body(static).clone()
        record = torch.tensor([7, 0], dtype=torch.int64)
        return capture._Graph(FakeGraph(body, static, output), static, output,
                              record, {"knn_topk": 2, "grid_interp": 1})
    monkeypatch.setattr(capture, "_eager", eager)
    monkeypatch.setattr(capture, "_capture", fake_capture)
    return calls


def test_first_call_eager_second_captures_then_replays(runner):
    owner = Owner()

    def body(ins):
        return ins["x"] * 2 + 1
    before = dict(LAUNCH_COUNTS)
    grid_knn.UNSAFE_COUNTS.clear()
    outs = [capture.run_captured(("k",), body,
                                 {"x": torch.full((3,), float(i))}, owner)
            for i in range(4)]
    assert runner == {"eager": 1, "capture": 1}
    for i, out in enumerate(outs):  # the inputs are copied in each call
        assert torch.equal(out, torch.full((3,), 2.0 * i + 1))
    # three replays, each counted as its graph's kernel nodes
    assert LAUNCH_COUNTS["knn_topk"] == before["knn_topk"] + 6
    assert LAUNCH_COUNTS["grid_interp"] == before["grid_interp"] + 3
    assert [int(c) for c in grid_knn.UNSAFE_COUNTS] == [7, 0] * 3
    # a replay's output is a clone, not the graph's buffer
    outs[-1].zero_()
    again = capture.run_captured(("k",), body, {"x": torch.ones(3)}, owner)
    assert torch.equal(again, torch.full((3,), 3.0))


def test_new_owner_or_shape_is_seen_anew(runner):
    a, b = Owner(), Owner()

    def body(ins):
        return ins["x"] + 1
    x = {"x": torch.zeros(2)}
    capture.run_captured(("k",), body, x, a)
    capture.run_captured(("k",), body, x, b)  # another owner: eager
    assert runner == {"eager": 2, "capture": 0}
    capture.run_captured(("k",), body, {"x": torch.zeros(5)}, b)  # shape
    assert runner == {"eager": 3, "capture": 0}
    capture.run_captured(("k",), body, x, b)
    assert runner == {"eager": 3, "capture": 1}


def test_least_recently_used_keys_go(runner):
    owner = Owner()

    def body(ins):
        return ins["x"]
    x = {"x": torch.zeros(1)}
    for key in range(capture.CACHE_SIZE + 1):
        capture.run_captured((key,), body, x, owner)
    assert len(capture._ENTRIES["sampler"]) == capture.CACHE_SIZE
    capture.run_captured((0,), body, x, owner)  # forgotten: eager again
    assert runner == {"eager": capture.CACHE_SIZE + 2, "capture": 0}
    capture.run_captured((0,), body, x, owner)
    assert runner["capture"] == 1


RUNNER_SPANS = {
    "eager": ["capture.key", "capture.eager"],
    "capture": ["capture.key", "capture.capture", "capture.replay",
                "capture.outputs"],
    "replay": ["capture.key", "capture.copy_in", "capture.replay",
               "capture.outputs"]}


def test_recording_is_its_own_key_and_spans_share_the_call(runner):
    owner = Owner()

    def body(ins):
        with profiling.device_span("body"):
            return ins["x"] * 2
    x = {"x": torch.ones(2)}
    for _ in range(2):  # spans off: eager, then captured
        capture.run_captured(("k",), body, x, owner)
    assert runner == {"eager": 1, "capture": 1}
    before = dict(LAUNCH_COUNTS)
    grid_knn.UNSAFE_COUNTS.clear()
    with profiling.recording_spans():
        for i in range(3):  # its own key: eager, captured, replayed
            out = capture.run_captured(("k",), body,
                                       {"x": torch.full((2,), float(i))},
                                       owner)
            assert torch.equal(out, torch.full((2,), 2.0 * i))
    assert runner == {"eager": 2, "capture": 2}
    assert LAUNCH_COUNTS["knn_topk"] == before["knn_topk"] + 4
    assert [int(c) for c in grid_knn.UNSAFE_COUNTS] == [7, 0] * 2
    calls = {}
    for s in profiling.spans():
        calls.setdefault(s.call, []).append(s)
    assert len(calls) == 3 and None not in calls
    for (call, spans), branch in zip(sorted(calls.items()),
                                     ("eager", "capture", "replay")):
        roots = [s for s in spans if s.parent is None]
        assert [s.name for s in sorted(roots, key=lambda s: s.start_ns)] \
            == RUNNER_SPANS[branch]
        host = {s.id: s.name for s in roots}  # where the body ran
        assert [host[s.parent] for s in spans if s.name == "body"] == {
            "eager": ["capture.eager"],
            "capture": ["capture.capture", "capture.replay"],
            "replay": ["capture.replay"]}[branch]
    capture.run_captured(("k",), body, x, owner)  # spans off: replayed
    assert runner == {"eager": 2, "capture": 2}
    with profiling.recording_spans(device=False):  # the graph that serves
        capture.run_captured(("k",), body, x, owner)
    assert runner == {"eager": 2, "capture": 2}
    assert sorted(s.name for s in profiling.spans()) == sorted(
        RUNNER_SPANS["replay"])


def test_trace_puts_a_calls_host_time_down_to_the_runners_spans(runner):
    """``h100_bench``'s trace reduction over a CPU profile of runner calls
    (the host's operators stand in for the card's): the idle time of a key
    built slowly is ``capture.key``'s."""
    owner = Owner()

    def key():
        time.sleep(0.02)
        return ("slow",)

    def stretch():
        for _ in range(3):
            capture.run_captured(key, lambda ins: ins["x"] + 1,
                                 {"x": torch.ones(4)}, owner)
        return 3
    summary = bench_trace.profile(stretch, torch.device("cpu"))
    idle = dict(summary.breakdown["idle_gaps"])
    assert idle["capture.key"] >= 0.05
    assert max(idle, key=idle.get) == "capture.key"
