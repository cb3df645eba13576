"""``NoSyncGuard``: a ``TorchFunctionMode`` that refuses host reads on the
tensors it follows, the condition for capturing a body in a CUDA graph on
the card, checked on the CPU (``tests/test_torch_graph_nosync.py`` says
what it refuses and why). It imports no JAX, so that the spawned ranks of
``tests/torch_dist.py`` run it too.
"""

import contextlib
import functools

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from pointcloud_style_transfer_torch.ops import distance, sampling
from pointcloud_style_transfer_torch.ops import grid_knn as P

T = torch.Tensor
REFUSED = {
    T.item, T.tolist, T.__bool__, T.__int__, T.__float__, T.__index__,
    T.nonzero, torch.nonzero, torch.argwhere, T.masked_select,
    torch.masked_select, torch.unique, T.unique, torch.unique_consecutive,
    T.cpu, T.numpy}


class SyncRefused(AssertionError):
    pass


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _mark(tree) -> None:
    for t in _tensors(tree):
        t._from_state = True


def _followed(tree) -> bool:
    return any(getattr(t, "_from_state", False) for t in _tensors(tree))


class NoSyncGuard(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        followed = _followed((args, kwargs))
        if followed:
            self._check(func, args)
        out = func(*args, **kwargs)
        if followed:
            _mark(out)
        return out

    @staticmethod
    def _check(func, args) -> None:
        name = getattr(func, "__name__", repr(func))
        if func in REFUSED:
            raise SyncRefused(f"{name} on a tensor derived from the state")
        if func in (T.__getitem__, T.__setitem__):
            index = args[1] if len(args) > 1 else None
            masks = [i for i in _tensors(index) if i.dtype == torch.bool]
            if masks:
                raise SyncRefused(f"{name} with a boolean mask")
            if func is T.__setitem__ and not isinstance(args[2],
                                                        torch.Tensor):
                raise SyncRefused("an indexed write of a host scalar")
        if func is torch.where and len(args) == 1:
            raise SyncRefused("torch.where(condition)")

    @contextlib.contextmanager
    def pause(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1


def plain_kernels(monkeypatch, guard: NoSyncGuard) -> None:
    """The kernel dispatchers the samplers reach run their plain versions
    with the guard paused; their outputs stay followed."""
    def paused(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            followed = _followed((args, kwargs))
            with guard.pause():
                out = fn(*args, **kwargs)
            if followed:
                _mark(out)
            return out
        return call
    for module, names in ((P, ("grid_interp", "grid_topk", "knn_topk",
                               "knn_f32packed")),
                          (distance, ("knn_topk", "knn_topk_plain")),
                          (sampling, ("ball_query_kernel",
                                      "farthest_point_sample_kernel"))):
        for name in names:
            monkeypatch.setattr(module, name, paused(getattr(module, name)))
