"""The 95th percentile of every window request's latency, from its start
(before normalising) to its answer on the host; nearest rank."""

import math


def read(run):
    lat = sorted(r["t_end"] - r["t_start"] for r in run.records)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
