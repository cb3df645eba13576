"""The program's span log for a driver that ``core/program_spans.py`` does
not record itself (it records only for the ``serve`` and ``train``
drivers): a driver's ``trace`` puts ``span_log(run, request)`` into
``run.state[program_spans.KEY]``, where every span reader finds it."""

from __future__ import annotations

from typing import Dict

from . import program_spans


def span_log(run, call) -> Dict[str, list]:
    """``core/program_spans.py``'s two stretches through ``call(run, i)``:
    the host's spans alone over ``trace_requests`` calls, then the device's
    too over ``WARM_CALLS`` more (eager, captured) and as many replays; or
    None for a program that records no spans."""
    from pointcloud_style_transfer_torch.utils import profiling
    if not hasattr(profiling, "recording_spans"):
        return None
    n = run.cell.traffic["trace_requests"]
    logs = {}
    for clock, calls in ((program_spans.HOST, n),
                         (program_spans.DEVICE, program_spans.WARM_CALLS + n)):
        with profiling.recording_spans(device=clock == program_spans.DEVICE):
            for _ in range(calls):
                call(run, run.state["next_id"])
                run.state["next_id"] += 1
        logs[clock] = profiling.spans()
    return logs
