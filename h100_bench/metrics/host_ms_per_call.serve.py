"""Host milliseconds of the sampler call, from its entry to its return
(before the answer's copy waits for the card), averaged over the window's
requests: the capture runner's draws, input copies and replay launch."""


def read(run):
    return 1e3 * sum(r["t_return"] - r["t_call"] for r in run.records) / \
        len(run.records)
