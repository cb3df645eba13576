"""Clouds delivered to the host in the window, over the window's seconds
(from its start to the last answer's arrival)."""


def read(run):
    return sum(r["units"] for r in run.records) / run.window_s
