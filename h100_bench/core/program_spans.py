"""The program's own spans (``pointcloud_style_transfer_torch.utils.
profiling``) over two stretches of the cell's traffic, recorded after the
window and the trace, for the readers of the capture runner's launch and of
in-loop stage times.

The first reader that asks runs both stretches once, through
``drivers/serve.py::request`` or ``drivers/train.py::mini_step``, and keeps
their logs in ``run.state``:

* ``HOST``: ``trace_requests`` requests or ``trace_steps`` mini-steps with
  the host's spans alone recorded, which replay the graph the window
  replayed (a graph that records device spans holds their event nodes, and
  more nodes take longer to launch);
* ``DEVICE``: with the device's spans too, 2 calls that make the recording
  graph (the runner keeps it under a key of its own: the first call runs
  eagerly, the second captures it), then as many that replay it.

A reader takes a span on one clock from that clock's stretch, and only from
the calls that replayed a graph captured earlier: those whose runner spans
hold ``capture.replay`` and no ``capture.capture``. A program that records
no spans (one older than the span log), a traffic mix with no such call
(the four-card one), or a stretch with no replayed call gives no log, and every
reader of it None.
"""

from __future__ import annotations

import collections
import statistics
from typing import Dict, List, Optional

KEY = "program_spans"
WARM_CALLS = 2  # eager, then captured, under the recording key
HOST, DEVICE = "host", "device"  # ``profiling.Span.clock``


def _stretches(run) -> Optional[Dict[str, list]]:
    from pointcloud_style_transfer_torch.utils import profiling
    if not hasattr(profiling, "recording_spans"):
        return None
    driver = run.cell.traffic["driver"]
    if driver == "serve":
        from ..drivers.serve import request as call
        n = run.cell.traffic["trace_requests"]
    elif driver == "train":
        from ..drivers.train import mini_step as call
        n = run.cell.traffic["trace_steps"]
    else:
        return None
    logs = {}
    for clock, calls in ((HOST, n), (DEVICE, WARM_CALLS + n)):
        with profiling.recording_spans(device=clock == DEVICE):
            for _ in range(calls):
                call(run, run.state["next_id"])
                run.state["next_id"] += 1
        logs[clock] = profiling.spans()
    return logs


def log(run) -> Optional[Dict[str, list]]:
    """Each stretch's spans by clock (run once a run), or None."""
    if KEY not in run.state:
        run.state[KEY] = _stretches(run)
    return run.state[KEY]


def replayed_calls(spans: list) -> Dict[int, List]:
    """The spans of each call that replayed a graph captured at an
    earlier call, by call id."""
    calls = collections.defaultdict(list)
    for s in spans:
        if s.call is not None:
            calls[s.call].append(s)
    return {c: ss for c, ss in calls.items()
            if any(s.name == "capture.replay" for s in ss)
            and not any(s.name == "capture.capture" for s in ss)}


def mean_ms(run, name: str, clock: str) -> Optional[float]:
    """Milliseconds of the spans ``name`` on ``clock`` in the replayed
    calls of that clock's stretch, averaged over those spans (one a step,
    a mini-step or a call); None where there is none."""
    logs = log(run)
    if not logs or not logs.get(clock):
        return None
    ms = [s.ms for ss in replayed_calls(logs[clock]).values() for s in ss
          if s.name == name and s.clock == clock]
    return statistics.fmean(ms) if ms else None
