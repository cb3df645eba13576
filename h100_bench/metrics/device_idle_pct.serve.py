"""The share of the traced stretch with no kernel, copy or set on the card
(rank 0 on several cards), in percent (``core/trace.py``)."""


def read(run):
    s = run.trace_summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
