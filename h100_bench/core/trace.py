"""A traced sub-window: ``torch.profiler`` over a steady stretch of the
cell's own traffic, reduced to what the per-layer readers and the result
line take.

* busy: the union of the intervals in which a kernel, copy or set ran on
  the card (overlaps counted once), inside the span the benchmark marks
  around the traced stretch (``WINDOW``); the window is that span's length
  on the same clock;
* device operations by name, summed: port kernels under their source name
  with template arguments (``kernel_name``), the rest under the profiler's
  name, shortened;
* idle gaps: the stretches of the window with nothing on the card, each
  instant put down to the innermost host span or operator running then
  (the drivers mark the request's stages), summed by that name.
"""

from __future__ import annotations

import dataclasses
import heapq
import re
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "h100_bench.window"
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    units: int                        # requests or steps traced
    kernels: List[Tuple[str, float]]  # (device op name, seconds), each run
    breakdown: dict
    # over every card of a multi-card run (its driver fills them in)
    all_busy_s: Optional[float] = None
    all_window_s: Optional[float] = None


def kernel_name(mangled: str) -> str:
    """A port kernel's name, template arguments written out
    (``knn_topk_kernel<1>``), from its demangled signature (the port's
    kernels live in an anonymous namespace) or its mangled symbol (the
    ``*_kernel`` identifier whose length is the digits before it; the
    anonymous namespace may put a hash that ends in digits right before
    those). Other names come back as they are."""
    found = re.search(r"\(anonymous namespace\)::([a-z][a-z0-9_]*_kernel)"
                      r"(<[\d, ]+>)?\(", mangled)
    if found:
        return found.group(1) + (found.group(2) or "").replace(" ", "")
    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run.group())):
            end = run.end() + int(run.group()[i:])
            ident = mangled[run.end():end]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", ident):
                args = re.match(r"I((?:Li\d+E)+)E", mangled[end:])
                args = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def short_name(name: str, width: int = 96) -> str:
    name = kernel_name(name)
    return name if len(name) <= width else name[:width - 3] + "..."


def union_length(intervals: List[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def host_segments(host: List[Tuple[int, int, str]], lo: int, hi: int
                  ) -> List[Tuple[int, int, str]]:
    """[lo, hi) cut where any host span or operator begins or ends, each
    piece named by the innermost one running over it (of those begun and
    not ended, the latest begun)."""
    cuts = sorted({lo, hi} | {t for s, e, _ in host for t in (s, e)
                              if lo < t < hi})
    host = sorted(host)
    heap: list = []  # (-start, end, name)
    out, i = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(host) and host[i][0] <= a:
            s, e, n = host[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        out.append((a, b, heap[0][2] if heap else "host idle (Python)"))
    return out


def overlap_by_name(spans: List[Tuple[int, int]],
                    segments: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """How much of ``spans`` (sorted, disjoint) each segment's name covers."""
    out: Dict[str, int] = {}
    j = 0
    for s, e in spans:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            a, b, name = segments[k]
            out[name] = out.get(name, 0) + min(b, e) - max(a, s)
            k += 1
    return out


def reduce(events, units: int) -> Summary:
    """``events``: (name, is_device, start_ns, end_ns) of a trace."""
    window = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    lo, hi = window[0]
    dev = [(n, s, e) for n, d, s, e in events if d and e > lo and s < hi]
    host = [(s, e, n) for n, d, s, e in events
            if not d and n != WINDOW and s < hi and e > lo]
    intervals = [(max(s, lo), min(e, hi)) for _, s, e in dev]
    busy = union_length(intervals)
    by_op: Dict[str, float] = {}
    for n, s, e in dev:
        key = short_name(n)
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
    by_host = {k: v / 1e9 for k, v in overlap_by_name(
        gaps(intervals, lo, hi), host_segments(host, lo, hi)).items()}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(busy / 1e9, (hi - lo) / 1e9, units,
                   [(n, (e - s) / 1e9) for n, s, e in dev],
                   {"device_ops": [[n, v] for n, v in top],
                    "idle_gaps": [[n, v] for n, v in idle]})


def profile(stretch: Callable[[], int], device) -> Summary:
    """Run ``stretch`` (it returns the requests or steps it completed)
    under the profiler, inside the ``WINDOW`` span, and reduce the trace
    (on a CPU device, for the tests, the host's operators stand in)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with prof_ctx(activities=activities) as prof:
        with record_function(WINDOW):
            units = stretch()
            sync()
    on_device = (lambda e: e.device_type() != torch.autograd.DeviceType.CPU) \
        if cuda else (lambda e: e.name().startswith("aten::"))
    # the benchmark's own spans also appear on the card's timeline, as
    # annotations covering the kernels they launched: left out of both
    events = [(e.name(), on_device(e),
               e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if not (on_device(e) and e.is_user_annotation())]
    return reduce(events, units)
