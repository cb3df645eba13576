"""Profiling and debugging helpers (counterpart of
``pointcloud_style_transfer_tpu/utils/profiling.py``, same names):

* ``trace(logdir)`` — context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) into ``logdir``;
* ``annotate(name)`` — a named region in the profiler timeline;
* ``device_memory_stats(device)`` — ``torch.cuda.memory_stats`` of a card,
  ``{}`` on the CPU;
* ``enable_nan_debugging()`` — autograd anomaly mode: a backward that
  produces a NaN raises at the op that made it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


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


def annotate(name: str):
    """Named region in the profiler timeline (cheap when no profiler
    runs)."""
    return torch.profiler.record_function(name)


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
