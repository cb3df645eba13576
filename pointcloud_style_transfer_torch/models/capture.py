"""The samplers' loops and the training steps as CUDA graphs: the
counterparts of the JAX package's ``jax.jit`` of a ``lax.scan``
(``pointcloud_style_transfer_tpu/models/samplers.py``) and of its jitted,
donated train and eval steps (``training/trainer.py::make_train_step``,
``make_eval_step``), one device program a call with no host round trip
inside.

``run_captured(key, body, inputs)`` runs ``body(inputs)`` (a dict of
device tensors -> a tensor, or a dict or tuple of them, nested) under
``key`` and the inputs' names, shapes and dtypes, as ``jax.jit`` caches by
its static arguments. A graph pays off only when a key comes back, so the
runner follows what it sees:

1. the first call with a key runs the body eagerly, on a side stream, and
   returns its result. A one-shot call (one cloud through ``cli.inference``)
   costs what the eager loop costs, and the call is the warm-up of a later
   capture: every kernel is built and loaded and every lazy device table
   made before it, which a capture could do neither of;
2. the second call copies the inputs into static buffers and captures the
   body into a graph with a memory pool of its own, then replays it;
3. every later call copies its inputs into the static buffers and replays.

A replay appends the kd-grid's unsafe counts to
``ops.grid_knn.UNSAFE_COUNTS`` (one device tensor, stacked inside the
graph) and returns a clone of each output, out of the graph's pool.

``LAUNCH_COUNTS`` counts the kernels the device runs: a capture launches
none, so the wrapper calls made while capturing are taken back out and
added again at each replay, one per kernel node of the graph.

A graph reads the model's parameters and buffers in place, at the
addresses it was captured with: ``model_key`` puts them in the key, so a
model whose tensors moved is seen anew, and one updated in place is read
as it stands. A training step's graph also reads and writes the
optimizer's state, the EMA and the schedule in place; its key holds their
addresses too (``tensors_key``), and its first call, run eagerly, is also
the warm-up PyTorch asks for before a backward is captured. The kd-grid's
and the time embedding's device tables are cached for the process's life,
so they outlive every graph.

Each caller names its cache (``cache``: the samplers' ``"sampler"``, the
trainer's ``"step"``), and each cache keeps its last ``CACHE_SIZE`` keys:
a trainer's train and eval graphs and the samplers' graphs, whose keys
differ in the tensors they read (``save_sample_results`` samples under the
EMA), never evict one another.

A capture or replay that fails raises; nothing falls back to the eager
loop.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..ops import grid_knn
from ..ops.kernels import LAUNCH_COUNTS

CACHE_SIZE = 4  # keys kept a cache (a captured one holds its own pool)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict             # the static input buffers
    output: Any              # a tensor or a tree of them, in the pool
    record: Optional[torch.Tensor]  # the replay's unsafe counts, in order
    launches: dict           # the kernel launches of a replay, by name


class _Entry(NamedTuple):
    owner: Any                   # a weak reference to the object it reads
    graph: Optional[_Graph]      # None until the key's second call


_ENTRIES: Dict[str, collections.OrderedDict] = {}  # by cache name
# one entry per capture made: host seconds of the capture with the graph's
# instantiation, ended by a synchronize
CAPTURES: list = []


def tensors_key(tensors: Dict[str, torch.Tensor]) -> tuple:
    """Names and addresses of tensors a graph reads or writes in place."""
    return tuple((n, t.data_ptr()) for n, t in tensors.items())


def model_key(model) -> tuple:
    """What a graph of ``model`` bakes in or reads in place: the net, its
    config, and every parameter's and buffer's name and address."""
    return (id(model.net), repr(model.config),
            tensors_key(model.net.state_dict(keep_vars=True)))


def _eager(body: Callable[[dict], Any], inputs: dict) -> Any:
    """``body(inputs)`` on a side stream, which the caller's stream then
    waits for; the outputs and the unsafe counts, made there, are marked as
    used on the caller's stream."""
    own = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(own)
    with torch.cuda.stream(side), grid_knn.recording_unsafe() as counts:
        output = body(inputs)
    own.wait_stream(side)
    for t in (*tree_leaves(output), *counts):
        t.record_stream(own)
    grid_knn.UNSAFE_COUNTS.extend(counts)
    return output


def _capture(body: Callable[[dict], Any], inputs: dict) -> _Graph:
    t0 = time.perf_counter()
    static = {n: t.clone() for n, t in inputs.items()}
    before = dict(LAUNCH_COUNTS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with grid_knn.recording_unsafe() as counts:
            output = body(static)
        record = torch.stack(counts) if counts else None
    torch.cuda.synchronize()
    launches = {}
    for name, n in before.items():  # captured, not launched
        if LAUNCH_COUNTS[name] != n:
            launches[name] = LAUNCH_COUNTS[name] - n
            LAUNCH_COUNTS[name] = n
    CAPTURES.append({"capture_s": time.perf_counter() - t0})
    return _Graph(graph, static, output, record, launches)


def run_captured(key: tuple, body: Callable[[dict], Any], inputs: dict,
                 owner, cache: str = "sampler") -> Any:
    """``body(inputs)``: eagerly at the first call under ``key``, from the
    CUDA graph captured at the second and replayed since. ``inputs`` maps
    names to CUDA tensors, of which the graph keeps static copies;
    ``owner`` is the object whose tensors the graph reads in place (the
    model's net, the trainer): a key whose owner is gone is seen anew, even
    where a new one took its address. ``cache`` names the cache the key
    is kept in. Returns the eager output or a clone of each of the
    graph's."""
    key = (key, tuple((n, tuple(t.shape), t.dtype, t.device)
                      for n, t in inputs.items()))
    entries = _ENTRIES.setdefault(cache, collections.OrderedDict())
    entry = entries.pop(key, None)
    if entry is None or entry.owner() is not owner:
        entry = None  # a stale graph's pool goes before anything new
        _remember(entries, key, _Entry(weakref.ref(owner), None))
        return _eager(body, inputs)
    graph = entry.graph
    if graph is None:
        graph = _capture(body, inputs)
    else:
        for name, t in inputs.items():
            graph.inputs[name].copy_(t)
    _remember(entries, key, _Entry(entry.owner, graph))
    graph.graph.replay()
    for name, n in graph.launches.items():
        LAUNCH_COUNTS[name] += n
    if graph.record is not None:
        grid_knn.UNSAFE_COUNTS.extend(graph.record.clone().unbind(0))
    return tree_map(torch.clone, graph.output)


def _remember(entries: collections.OrderedDict, key: tuple,
              entry: _Entry) -> None:
    entries[key] = entry  # the most recently used last
    while len(entries) > CACHE_SIZE:
        entries.popitem(last=False)
