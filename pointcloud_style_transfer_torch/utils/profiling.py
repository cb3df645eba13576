"""Profiling and debugging helpers (counterpart of
``pointcloud_style_transfer_tpu/utils/profiling.py``, same names):

* ``trace(logdir)`` — context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``logdir``;
* ``annotate(name)`` — a host span: a named region in the profiler
  timeline and, while spans are recorded, a record in the span log; a
  shared no-op when neither is on;
* ``device_span(name)`` — a span of device work that a CUDA graph keeps
  (see below);
* ``recording_spans()``, ``spans()`` — the span log;
* ``device_memory_stats(device)`` — ``torch.cuda.memory_stats`` of a card,
  ``{}`` on the CPU;
* ``enable_nan_debugging()`` — autograd anomaly mode: a backward that
  produces a NaN raises at the op that made it.

The span log. Inside ``with recording_spans():`` every ``annotate`` and
``device_span`` block appends a ``Span``: its name, its call, its parent
span and its start and end. A call is one call of a function marked
``one_call`` (the samplers' loops, ``train_step``, the capture runner): the
spans of one call share its id, the outermost marked call's. A host span
and a device span outside a body that the capture runner runs take
``time.perf_counter_ns``. Inside such a body on the card (``body_spans``)
a device span is a pair of CUDA events (``external=True``, so that a
capture keeps them as event-record nodes and every replay times the block
again on the device clock) and reads as nanoseconds from an event recorded
where the body starts. Nothing is read back inside a body: a run's events
are read after it, when the runner calls ``collect`` before that graph
replays again, and at ``spans()``, which wait for the run's last event.
``recording_spans(device=False)`` records the host spans alone: then, as
with spans not recorded, ``device_span`` records nothing and a captured
body holds no extra node, so the graph that runs is the one that serves.
One thread records at a time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"
HOST, DEVICE = "host", "device"  # a span's clock

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the block (CPU ops, and the card's kernels when one is
    present) and write ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class Span(NamedTuple):
    """One recorded span. ``clock`` is ``HOST`` (``start_ns`` and
    ``end_ns`` from ``time.perf_counter_ns``) or ``DEVICE`` (nanoseconds on
    the card from the event where its call's body starts)."""
    id: int
    name: str
    call: Optional[int]    # the ``one_call`` call it ran in
    parent: Optional[int]  # the id of the span it ran in
    clock: str
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _State:
    def __init__(self):
        self.on = False             # host spans recorded
        self.device = False         # device spans too
        self.log: List[Span] = []
        self.stack: List[int] = []  # the open spans' ids, innermost last
        self.call: Optional[int] = None
        self.calls = 0              # call ids handed out
        self.ids = 0                # span ids handed out
        self.body: Optional[_Body] = None
        self.pending: list = []     # (body, call, parent) of runs not read


_S = _State()


def _new_id() -> int:
    _S.ids += 1
    return _S.ids


def _profiler_range(name: str):
    """An entered ``record_function(name)`` while a profiler runs, else
    None."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _HostSpan:
    """A span on the host's clock."""
    __slots__ = ("name", "rf", "id", "parent", "call", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        self.id, self.call = _new_id(), _S.call
        self.parent = _S.stack[-1] if _S.stack else None
        _S.stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _S.stack.pop()
        _S.log.append(Span(self.id, self.name, self.call, self.parent, HOST,
                           self.start, end))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True, external=True)


class _Body:
    """The device spans of one body on the card: its start and end events
    and each span's (name, parent's index or None, start and end events).
    A captured body's events are nodes of its graph, timed anew at every
    replay."""

    def __init__(self):
        self.origin, self.end = _event(), _event()
        self.spans: list = []
        self.open: List[int] = []

    def __enter__(self):
        self.outer, _S.body = _S.body, self
        self.origin.record()
        return self

    def __exit__(self, kind, *exc):
        _S.body = self.outer
        if kind is None:
            self.end.record()
        return False


class _EventSpan:
    """A device span inside a body on the card: a pair of events."""
    __slots__ = ("name", "body", "rf", "end")

    def __init__(self, name: str, body: _Body):
        self.name, self.body = name, body

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        body = self.body
        start, self.end = _event(), _event()
        body.spans.append((self.name, body.open[-1] if body.open else None,
                           start, self.end))
        body.open.append(len(body.spans) - 1)
        start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.body.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A host span named ``name``: a region of the profiler's timeline
    (``record_function``) while a profiler runs, and a ``Span`` of the log
    while spans are recorded; a shared ``nullcontext`` when neither is
    on."""
    if _S.on:
        return _HostSpan(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def device_span(name: str):
    """A span of the device work launched inside it, while spans are
    recorded: timed by CUDA events inside a body the capture runner runs
    on the card (in a capture, two event-record nodes that every replay
    times again), else on the host's clock; a shared ``nullcontext``
    when device spans are not recorded."""
    if not _S.device:
        return _NULL
    if _S.body is None:
        return _HostSpan(name)
    return _EventSpan(name, _S.body)


def one_call(fn):
    """Decorator: the spans recorded while ``fn`` runs share one call id,
    that of the outermost call so marked."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _S.on or _S.call is not None:
            return fn(*args, **kwargs)
        _S.calls += 1
        _S.call = _S.calls
        try:
            return fn(*args, **kwargs)
        finally:
            _S.call = None
    return wrapped


def device_spans_on() -> bool:
    """Whether device spans are recorded: a capture runner's graph key holds
    it, since a graph that records them holds their event nodes."""
    return _S.device


@contextlib.contextmanager
def recording_spans(device: bool = True):
    """Record spans in the block, into a log emptied on entry: the host's,
    and with ``device`` the device spans too. The runs still unread are
    read on exit."""
    _S.log, _S.pending, _S.stack = [], [], []
    _S.on, _S.device = True, device
    try:
        yield
    finally:
        _S.on = _S.device = False
        _collect_all()


def spans() -> List[Span]:
    """The log of the last ``recording_spans`` block, with every run's
    device spans read (which waits for them)."""
    _collect_all()
    return list(_S.log)


def body_spans():
    """For the capture runner, around a body it runs or captures on the
    card: a ``_Body`` that the body's device spans go into (entered, its
    start event recorded), or a ``nullcontext`` of None when device spans
    are not recorded."""
    return _Body() if _S.device else _NULL


def ran(body: Optional[_Body]) -> None:
    """For the capture runner, after ``body`` ran (eagerly, or a replay of
    the graph that holds it): its events are read later (``collect``), as
    spans of the current call under the innermost open span."""
    if body is not None and _S.device:
        _S.pending.append((body, _S.call, _S.stack[-1] if _S.stack else None))


def _read(body: _Body, call: Optional[int], parent: Optional[int]) -> None:
    body.end.synchronize()
    ids: List[int] = []
    for name, up, start, end in body.spans:
        ids.append(_new_id())
        _S.log.append(Span(
            ids[-1], name, call, parent if up is None else ids[up], DEVICE,
            round(body.origin.elapsed_time(start) * 1e6),
            round(body.origin.elapsed_time(end) * 1e6)))


def collect(body: Optional[_Body]) -> None:
    """Read the runs of ``body`` not read yet into the log (before its
    graph replays again and times its events anew); each waits for its
    run's end event."""
    if body is None or not _S.pending:
        return
    keep = []
    for run in _S.pending:
        if run[0] is body:
            _read(*run)
        else:
            keep.append(run)
    _S.pending = keep


def _collect_all() -> None:
    pending, _S.pending = _S.pending, []
    for run in pending:
        _read(*run)


def device_memory_stats(device: Optional[str | torch.device] = None
                        ) -> Dict:
    """The allocator's statistics (``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ...) of a CUDA device, by default the
    current one when a card is present; ``{}`` on the CPU."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


def enable_nan_debugging() -> None:
    """Raise where a NaN is made in a backward pass (autograd anomaly
    mode; slow, for debugging only)."""
    torch.autograd.set_detect_anomaly(True)
