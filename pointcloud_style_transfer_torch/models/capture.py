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

Its host spans (``utils.profiling.annotate``), under each call's id:
``capture.key`` (the key, ``key`` given as a function built inside it),
``capture.agree``, ``capture.eager``, ``capture.capture``,
``capture.copy_in``, ``capture.replay`` (around the graph's launch) and
``capture.outputs`` (the counters' books and the clones). While spans are
recorded (``profiling.recording_spans``) with the device's, a key is
another key, so a recording graph is run eagerly, captured and replayed on
its own, and holds the body's device spans as event nodes; a graph
captured otherwise holds none.

A body that runs collectives (the point-sharded sampler, the meshed train
and eval steps: NCCL's all-gathers and all-reduces inside the graph, the
counterparts of the collectives inside JAX's compiled programs) names
their process groups (``groups``). Every rank of them must then take the
same branch at the same call: a rank that captures records its
collectives without running them, so a rank that runs the body or
replays meanwhile would wait for it forever. A rank's own choice rests on
its own state (the entry's owner is a weak reference, the keys hold
addresses, the cache forgets its oldest keys), so the ranks agree on it
first (``agree``: one small all-reduce a group, outside the graph): a call
runs eagerly where any rank would, captures where any rank has no graph
yet, and replays only where every rank has one. After a capture the ranks
agree that each of them made it before any replays: one rank's failed
capture raises on every rank. ``release`` drops every graph, which must
come before the process group is destroyed.
"""

from __future__ import annotations

import collections
import gc
import time
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from ..ops import grid_knn
from ..ops.kernels import LAUNCH_COUNTS
from ..utils import profiling
from ..utils.profiling import annotate

CACHE_SIZE = 4  # keys kept a cache (a captured one holds its own pool)
# a key's branches, in the order its calls move through them
EAGER, CAPTURE, REPLAY = 0, 1, 2


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict             # the static input buffers
    output: Any              # a tensor or a tree of them, in the pool
    record: Optional[torch.Tensor]  # the replay's unsafe counts, in order
    launches: dict           # the kernel launches of a replay, by name
    spans: Any = None        # its device spans' events, while recording


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
    with torch.cuda.stream(side), grid_knn.recording_unsafe() as counts, \
            profiling.body_spans() as spans:
        output = body(inputs)
    profiling.ran(spans)
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
    try:
        # thread_local: a CUDA call of another thread (a process group's
        # watchdog querying its events) does not void the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with grid_knn.recording_unsafe() as counts, \
                    profiling.body_spans() as spans:
                output = body(static)
            record = torch.stack(counts) if counts else None
        torch.cuda.synchronize()
    finally:  # captured, not launched
        launches = {name: LAUNCH_COUNTS[name] - n
                    for name, n in before.items() if LAUNCH_COUNTS[name] != n}
        LAUNCH_COUNTS.update(before)
    CAPTURES.append({"capture_s": time.perf_counter() - t0})
    return _Graph(graph, static, output, record, launches, spans)


def agree(groups: Sequence, value: int) -> int:
    """The least ``value`` of the ranks of each process group of ``groups``
    in turn: over a mesh's axis groups in turn, the least over the mesh.
    One all-reduce of one int a group, on the card under NCCL (then read
    back, which waits for the work the stream holds) and on the host under
    gloo."""
    for group in groups:
        device = "cuda" if "nccl" in str(dist.get_backend(group)) else "cpu"
        t = torch.tensor([value], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        value = int(t.item())
    return value


def _capture_agreed(body: Callable[[dict], Any], inputs: dict,
                    groups: Sequence) -> _Graph:
    """``_capture``, held until every rank of ``groups`` has made its own:
    a capture that failed on any rank raises on every rank."""
    if not groups:
        return _capture(body, inputs)
    try:
        graph = _capture(body, inputs)
    except Exception:
        agree(groups, 0)
        raise
    if not agree(groups, 1):
        raise RuntimeError("the capture failed on another rank of the "
                           "process group")
    return graph


@profiling.one_call
def run_captured(key: tuple | Callable[[], tuple],
                 body: Callable[[dict], Any], inputs: dict, owner,
                 cache: str = "sampler", groups: Sequence = ()) -> Any:
    """``body(inputs)``: eagerly at the first call under ``key`` (or the
    key ``key()`` builds), from the CUDA graph captured at the second and
    replayed since. ``inputs`` maps names to CUDA tensors, of which the
    graph keeps static copies; ``owner`` is the object whose tensors the
    graph reads in place (the model's net, the trainer): a key whose owner
    is gone is seen anew, even where a new one took its address. ``cache``
    names the cache the key is kept in. ``groups`` are the process groups
    whose collectives ``body`` runs: their ranks agree on each call's
    branch and on each capture (``agree``). Returns the eager output or a
    clone of each of the graph's."""
    with annotate("capture.key"):
        key = (key() if callable(key) else key,
               tuple((n, tuple(t.shape), t.dtype, t.device)
                     for n, t in inputs.items()), profiling.device_spans_on())
        entries = _ENTRIES.setdefault(cache, collections.OrderedDict())
        entry = entries.pop(key, None)
        if entry is not None and entry.owner() is not owner:
            entry = None
        branch = (EAGER if entry is None else CAPTURE if entry.graph is None
                  else REPLAY)
    if groups:
        with annotate("capture.agree"):
            branch = agree(groups, branch)
    if branch == EAGER:
        entry = None  # a stale graph's pool goes before anything new
        _remember(entries, key, _Entry(weakref.ref(owner), None))
        with annotate("capture.eager"):
            return _eager(body, inputs)
    if branch == CAPTURE:
        entry = None  # as above, where this rank alone had a graph
        with annotate("capture.capture"):
            graph = _capture_agreed(body, inputs, groups)
    else:
        graph = entry.graph
        # its last replay's device spans, before this one times them anew
        profiling.collect(graph.spans)
        with annotate("capture.copy_in"):
            for name, t in inputs.items():
                graph.inputs[name].copy_(t)
    _remember(entries, key, _Entry(weakref.ref(owner), graph))
    with annotate("capture.replay"):
        graph.graph.replay()
        profiling.ran(graph.spans)
    with annotate("capture.outputs"):
        for name, n in graph.launches.items():
            LAUNCH_COUNTS[name] += n
        if graph.record is not None:
            grid_knn.UNSAFE_COUNTS.extend(graph.record.clone().unbind(0))
        return tree_map(torch.clone, graph.output)


def release() -> None:
    """Drop every cached graph with its pool. A graph that holds NCCL
    collectives holds its communicator: release the graphs before
    ``torch.distributed.destroy_process_group`` (on four ranks a run that
    destroyed its group with the graphs alive hung at its end). Each
    cache is emptied in place, so that a caller still holding one holds
    no graph."""
    for entries in _ENTRIES.values():
        entries.clear()
    _ENTRIES.clear()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _remember(entries: collections.OrderedDict, key: tuple,
              entry: _Entry) -> None:
    entries[key] = entry  # the most recently used last
    while len(entries) > CACHE_SIZE:
        entries.popitem(last=False)
