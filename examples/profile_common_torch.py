"""What the port's profiling, probe and demo scripts (``examples/*_torch.py``)
share: the device, a model with seeded random weights, the grid's
environment knobs, a stub put in place for one variant, replay timing with
CUDA events and a profiled call's device kernels by name.

A timed body runs through ``models.capture.run_captured``: on the card its
first call runs eagerly (the warm-up: kernels built and loaded, lazy device
tables made), its second is captured into a CUDA graph and replayed, and
later calls replay it; on the CPU every call runs the body eagerly. The
runner keys a graph by the key given and the inputs' names, shapes and
dtypes, not by the Python functions the body calls, so every key here holds
what the body stubs, and each script calls ``capture.release()`` before a
body, which drops the graphs of the body before.
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import sys
import time
from typing import Callable, Optional

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from pointcloud_style_transfer_torch.config import Config  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.models import (  # noqa: E402
    PointCloudDiffusionModel, capture)
from pointcloud_style_transfer_torch.ops import grid_knn  # noqa: E402
from pointcloud_style_transfer_torch.ops.kernels import \
    LAUNCH_COUNTS  # noqa: E402

CACHE = "profile"  # the capture runner's cache of these scripts' bodies
SEED = 0  # the random weights' seed; each script's draws come from it too
TOP = 15  # a profiled call's device kernels printed, by device time


def script_args(parser, config: bool = True) -> None:
    """``--device`` and, for a script that builds ``Config()``,
    ``--config FIELD=VALUE ...`` (fields set for the run: small sizes and
    widths on the CPU)."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; no card raises) or cpu")
    if config:
        parser.add_argument(
            "--config", nargs="+", action="extend", default=[],
            metavar="FIELD=VALUE",
            help="Config fields, e.g. total_points=1024 global_points=256 "
                 "feature_dim=32 time_embed_dim=16 use_amp=false")


def config_of(args, **fields) -> Config:
    """``Config(**fields)`` with the script's ``--config`` fields, each
    read as its default's type."""
    defaults = Config()
    for item in args.config:
        name, sep, text = item.partition("=")
        if not sep or not hasattr(defaults, name):
            raise ValueError(f"--config takes FIELD=VALUE of Config's "
                             f"fields, got {item!r}")
        kind = type(getattr(defaults, name))
        fields.setdefault(name, text.lower() in ("1", "true", "yes")
                          if kind is bool else kind(text))
    return Config(**fields)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def random_model(device: str | torch.device,
                 config: Optional[Config] = None) -> PointCloudDiffusionModel:
    """A model of ``config`` (``Config()``) on ``device``
    (``resolve_device``: no card raises unless ``cpu``), its weights drawn
    from ``SEED``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return PointCloudDiffusionModel(config or Config(), device)


def grid_knobs(environ=None) -> dict:
    """The grid's keywords from the JAX scripts' environment knobs in
    ``environ`` (``os.environ``), each defaulting to the production grid
    (``ops/grid_knn.py``'s entry points): ``PCST_PROF_GRID`` ("16,12,8"),
    ``PCST_PROF_TQ``, ``PCST_PROF_SLOT_CAP``, ``PCST_PROF_FALLBACK_CAP``,
    ``PCST_PROF_Z_HALO``, ``PCST_PROF_XY_HALO`` (an int or "Hx,Hy").
    ``grid_knobs({})`` is the production grid whatever the shell sets."""
    env = (os.environ if environ is None else environ).get
    grid = ",".join(map(str, grid_knn.GRID_SHAPE))
    xy = env("PCST_PROF_XY_HALO", "1")
    return {"grid_shape": tuple(int(v) for v in
                                env("PCST_PROF_GRID", grid).split(",")),
            "tq": int(env("PCST_PROF_TQ", "128")),
            "slot_cap": int(env("PCST_PROF_SLOT_CAP",
                                str(grid_knn.SLOT_CAP))),
            "fallback_cap": int(env("PCST_PROF_FALLBACK_CAP", "4096")),
            "z_halo": int(env("PCST_PROF_Z_HALO", "2")),
            "xy_halo": int(xy) if "," not in xy else tuple(
                int(v) for v in xy.split(","))}


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` is ``value`` within the block (a variant's stub, or
    the grid knobs bound to an entry point); yields the function it
    replaced."""
    own = getattr(module, name)
    setattr(module, name, value)
    try:
        yield own
    finally:
        setattr(module, name, own)


@contextlib.contextmanager
def grid_bound(knobs: dict):
    """The grid's entry points with ``knobs`` (``grid_knobs``) bound within
    the block: ``grid_knn_interpolate``, ``grid_knn_interpolate_layout``,
    ``grid_knn_interpolate_layout_batched`` (which takes no z halo) and
    the ``grid_knn`` that ``knn(backend="grid")`` calls; the samplers reach
    the grid through them."""
    from pointcloud_style_transfer_torch.ops import distance
    flat = {k: v for k, v in knobs.items() if k != "z_halo"}
    with contextlib.ExitStack() as stack:
        for module, name, kw in (
                (grid_knn, "grid_knn_interpolate", knobs),
                (grid_knn, "grid_knn_interpolate_layout", knobs),
                (grid_knn, "grid_knn_interpolate_layout_batched", flat),
                (distance, "grid_knn", knobs)):
            stack.enter_context(patched(module, name, functools.partial(
                getattr(module, name), **kw)))
        yield


class Owner:
    """What a body's graph reads in place, where no model is: the tensors
    its closure holds (the capture runner keeps a weak reference)."""


def graphed(device: torch.device) -> bool:
    """Whether a body runs through the capture runner: on the card."""
    return device.type == "cuda"


def run_body(key: tuple, body: Callable[[dict], torch.Tensor], inputs: dict,
             owner, device: torch.device) -> torch.Tensor:
    """``body(inputs)``: eagerly on the CPU, through the capture runner on
    the card (cache ``CACHE``) under ``key``."""
    if not graphed(device):
        return body(inputs)
    return capture.run_captured(key, body, inputs, owner, cache=CACHE)


def timed_turns(fns: list[Callable[[], object]], reps: int,
                device: torch.device) -> list[list[float]]:
    """ms of each call of each of ``fns``, called in turns ``reps`` times
    (``fns[0]``, ``fns[1]``, ..., ``fns[0]``, ...), so that a drift of the
    card's clock or power state falls on each alike: on the card between
    CUDA events recorded around each call, read after one synchronise (a
    replay is one launch, so the events time the device); on the CPU the
    host clock."""
    if device.type != "cuda":
        out: list[list[float]] = [[] for _ in fns]
        for _ in range(reps):
            for ms, fn in zip(out, fns):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
        return out
    events = [[(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
              for _ in fns]
    torch.cuda.synchronize()
    for r in range(reps):
        for ev, fn in zip(events, fns):
            ev[r][0].record()
            fn()
            ev[r][1].record()
    torch.cuda.synchronize()
    return [[start.elapsed_time(end) for start, end in ev] for ev in events]


def timed_calls(fn: Callable[[], object], reps: int,
                device: torch.device) -> list[float]:
    """ms of each of ``reps`` calls of ``fn`` (``timed_turns``)."""
    return timed_turns([fn], reps, device)[0]


def spread(ms: list[float]) -> float:
    """(largest - least) / least."""
    return (max(ms) - min(ms)) / min(ms)


def marginal(base: list[float], stubbed: list[float]) -> dict:
    """``median(base) - median(stubbed)``: the cost in context of what
    ``stubbed`` leaves out. It is resolved only where it exceeds the
    spread (largest - least) of both readings; an unresolved one lies
    within their noise and says nothing of that cost. Returns ``ms``,
    ``noise_ms`` (the larger spread) and ``resolved``."""
    ms = statistics.median(base) - statistics.median(stubbed)
    noise = max(max(base) - min(base), max(stubbed) - min(stubbed))
    return {"ms": ms, "noise_ms": noise, "resolved": abs(ms) > noise}


def marginal_note(m: dict) -> str:
    return (f"{m['ms']:+.4f} ms" + ("" if m["resolved"] else
            f" (unresolved: within the {m['noise_ms']:.4f} ms spread)"))


def denoiser_launches(model) -> int:
    """``csrc/denoiser_block.cu``'s launches a ``predict_noise`` call of
    ``model``: one a residual block where its eval-mode blocks take the op
    (``NoisePredictor.fused_blocks``) on the card, else none."""
    net = model.net.noise_predictor
    takes = model.device.type == "cuda" and net.fused_blocks
    return len(net.blocks) if takes else 0


def launches_of(fn: Callable[[], object]) -> dict:
    """The port's kernel launches of one call of ``fn`` (``LAUNCH_COUNTS``
    before and after; a replay adds its graph's kernel nodes), by name,
    the kernels it did not launch left out."""
    before = dict(LAUNCH_COUNTS)
    fn()
    return {n: c - before[n] for n, c in LAUNCH_COUNTS.items()
            if c != before[n]}


def measure(run: Callable[[], torch.Tensor], reps: int,
            device: torch.device) -> dict:
    """A body's calls ``run``: the first (eager on the card), the second
    (captured and replayed), ``reps`` timed (``timed_calls``) and one more
    whose launches are read (``launches_of``). Returns the three outputs
    kept (``first``, ``second``, ``last``), ``ms`` and ``launches``."""
    first, second = run(), run()
    ms = timed_calls(run, reps, device)
    last = []
    launches = launches_of(lambda: last.append(run()))
    return {"first": first, "second": second, "last": last[0], "ms": ms,
            "launches": launches}


def timed_body(key: tuple, body: Callable[[dict], object], inputs: dict,
               owner, reps: int, device: torch.device, per: int = 1) -> dict:
    """``body`` (``per`` rounds of the work timed, chained) measured as
    ``measure`` measures it under ``key`` (``run_body``), every earlier
    graph dropped first (``capture.release``). Returns ms a round (the
    median of ``reps`` calls / ``per``), the least, the spread, the runs,
    the launches a round and the first call's output."""
    capture.release()
    res = measure(lambda: run_body(key, body, inputs, owner, device), reps,
                  device)
    per_round = [ms / per for ms in res["ms"]]
    return {"ms": statistics.median(per_round), "best_ms": min(per_round),
            "spread": spread(per_round), "runs_ms": per_round,
            "launches": {k: n / per for k, n in res["launches"].items()},
            "first": res["first"]}


def device_kernels(fn: Callable[[], object]) -> dict:
    """One call of ``fn`` on the card under ``torch.profiler``: wall ms to
    a synchronise, device busy ms and share (the device kernels' and
    copies' time), their count, the ``TOP`` by device time with their
    launches, and every one's device ms by name (``by_name``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "n_kernels": sum(r[1] for r in rows),
            "top": [{"name": name[:120], "launches": n, "ms": ms}
                    for name, n, ms in rows[:TOP]],
            "by_name": {name: ms for name, _, ms in rows}}


def print_kernels(tag: str, what: str, prof: dict,
                  card: Optional[str] = None) -> None:
    print(f"{tag} {what}: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
          f"{prof['n_kernels']} device kernels and copies"
          + (f" ({card})" if card else ""))
    for i, row in enumerate(prof["top"]):
        print(f"{tag}   {i + 1:2d}. {row['ms']:9.4f} ms {row['launches']:6d}x "
              f"{row['name']}")
