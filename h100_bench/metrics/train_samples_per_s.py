"""Clouds trained on in the window's mini-steps, over the window's seconds
(from its start to the last step's synchronised end)."""


def read(run):
    return sum(r["units"] for r in run.records) / run.window_s
