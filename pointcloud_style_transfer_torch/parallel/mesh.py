"""Device mesh and batch placement on ``torch.distributed`` (counterpart of
``pointcloud_style_transfer_tpu/parallel/mesh.py``).

One process per device. A mesh is a ``DeviceMesh`` over the default
process group with named axes:

* ``data`` — batch data parallelism: every rank holds the parameters, takes
  its slice of the batch, and the gradients are all-reduced over the axis
  (``sharded.py``);
* ``points`` — point-cloud "sequence" parallelism: the cross-point
  primitives (Chamfer, kNN) rotate their reference shards around a ring of
  the axis's ranks (``ring.py``), and the samplers split their kNN queries
  over it (``sharded_sampler.py``).

Tensors are rank-local: ``shard_batch`` returns this rank's slice, and the
collectives are explicit. The backend follows the device: NCCL for CUDA
tensors, gloo for CPU tensors; a tensor on the other device raises
(``check_backend``), nothing is moved to the CPU.

``make_mesh`` may, as the JAX one does, take fewer ranks than the world
has: the first n ranks form the mesh. The other ranks get a mesh that does
not hold them (``DeviceMesh.get_coordinate()`` is None), and every
function of ``parallel/`` raises on it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
POINTS_AXIS = "points"


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_backend(device_type: str, group=None) -> None:
    """Raise unless ``group``'s backend serves tensors of ``device_type``
    (NCCL for ``cuda``, gloo for ``cpu``)."""
    want = _backend_for(device_type)
    have = str(dist.get_backend(group))
    if want not in have:
        raise ValueError(f"{device_type} tensors need a {want} process "
                         f"group; this one is {have}")


def _init_default_group(device_type: str) -> None:
    """Initialise the default process group: from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when it is
    set, else as a group of this one process."""
    if dist.is_initialized():
        check_backend(device_type)
        return
    backend = _backend_for(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                     "MASTER_PORT")):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape: Optional[Dict[str, int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the first prod(shape) ranks of the default
    group, with ``shape``'s keys as its dimension names.

    Args:
        shape: e.g. {"data": 4, "points": 2}. Defaults to every rank on one
            ``data`` axis.
        device_type: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``. Initialises the default group (NCCL or gloo) if
            nothing has.
    """
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if not shape:
        shape = {DATA_AXIS: world}
    names = tuple(shape)
    sizes = tuple(int(s) for s in shape.values())
    n = math.prod(sizes)
    if n > world:  # checked before a group is started
        raise ValueError(f"mesh shape {dict(shape)} needs {n} ranks, have "
                         f"{world}")
    _init_default_group(device_type)
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``; 1 for an axis the mesh does not have."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def _check_member(mesh) -> None:
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for an axis the mesh does
    not have). Raises on a rank the mesh does not hold."""
    _check_member(mesh)
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; None for an
    axis the mesh does not have."""
    axis_rank(mesh, axis)
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) \
        else None


def mesh_key(mesh, *groups) -> tuple:
    """What a CUDA graph of collectives on ``mesh`` bakes in: its axes with
    their sizes and, for each of ``groups`` (None where there is none),
    its name, which names its communicator, and its global ranks."""
    return (tuple(zip(mesh.mesh_dim_names or (), mesh.mesh.shape)),
            tuple(None if g is None else
                  (g.group_name, tuple(dist.get_process_group_ranks(g)))
                  for g in groups))


def replicated(mesh):
    """The ``DTensor`` placements of a replicated value (the counterpart of
    ``NamedSharding(mesh, P())``); nothing in the port consumes them."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def batch_sharding(mesh, shard_points: bool = False):
    """The ``DTensor`` placements of a [B, N, 3] batch: the batch over
    ``data``, optionally the points over ``points``."""
    from torch.distributed.tensor import Replicate, Shard
    place = {DATA_AXIS: Shard(0)}
    if shard_points:
        place[POINTS_AXIS] = Shard(1)
    return [place.get(name, Replicate()) for name in mesh.mesh_dim_names]


def local_slice(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous 1/n of ``x`` along ``dim``, n the ranks of
    ``axis``."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not "
                         f"divisible by the {axis} axis ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_rank(mesh, axis) * size, size)


def shard_batch(x: torch.Tensor, mesh, shard_points: bool = False
                ) -> torch.Tensor:
    """This rank's slice of a [B, N, ...] batch that every rank holds: the
    batch over ``data`` and, with ``shard_points``, the points over
    ``points`` (contiguous slices, rank order)."""
    x = local_slice(x, 0, mesh, DATA_AXIS)
    if shard_points:
        x = local_slice(x, 1, mesh, POINTS_AXIS)
    return x.contiguous()


@torch.no_grad()
def replicate(tree, mesh):
    """Every tensor of ``tree`` (a tensor, or dicts and lists of them)
    broadcast in place from the mesh's first rank, so that every rank starts
    identical; other leaves are left alone. Returns ``tree``."""
    _check_member(mesh)
    groups = [mesh.get_group(i) for i in range(mesh.ndim)]

    def visit(x):
        if isinstance(x, torch.Tensor):
            for g in groups:
                dist.broadcast(x.detach(), src=dist.get_global_rank(g, 0),
                               group=g)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
    visit(tree)
    return tree


class AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose gradient is the sum of the ranks' output
    gradients (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class AllGather(torch.autograd.Function):
    """Concatenate the ranks' tensors of ``group`` along ``dim`` in rank
    order; the gradient of this rank's piece is the sum over ranks of their
    output gradients' slice of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None,
                None)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``AllGather`` without a gradient: ``all_gather_into_tensor`` of
    ``x`` moved to the front, in rank order along ``dim``."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)
