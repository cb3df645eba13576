"""A stage timed alone on the card: ``calls`` calls of it captured in one
CUDA graph, the graph replayed ``replays`` times between CUDA events, the
median replay over ``calls`` -- milliseconds a call, with no launch gaps
of the host's in it."""

from __future__ import annotations

import statistics
from typing import Callable


def ms_per_call(fn: Callable[[], object], calls: int = 10,
                replays: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up a capture needs
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()  # its first replay uploads the graph
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)
