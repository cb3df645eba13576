"""The samplers' loop bodies read nothing back to the host: the condition
for capturing them in a CUDA graph on the card, checked here on the CPU.

``NoSyncGuard`` (``torch_nosync.py``, which imports no JAX, so that the
spawned ranks of ``test_torch_mesh_graph.py`` use it too; a
``TorchFunctionMode``) follows every tensor derived from
the sampler's inputs (the clouds and the draws) and refuses on them what
would synchronise the card or copy host data into a graph: ``item``,
``tolist``, ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
``nonzero`` and the other ops whose output shape depends on the data, a
boolean-mask index, a copy to the host, and an indexed write of a Python
scalar (which becomes a host tensor copied to the device). Tensors derived
only from constants (the CPU schedule, the grid's partition tables) are not
followed. The kernels' plain versions, which stand on the CPU for the CUDA
kernels, run with the guard paused: their outputs are followed all the
same.

The bodies run at small sizes with a small grid ((2, 2, 2), slot_cap 256,
tq 64): ``guided_sample_loop`` on the hierarchical branch at B = 1 (the
one-cloud ladder) and B = 2 (the flat-batched ladder), ``--fast``
(``guided_sample_loop_coarse``, the kNN ladder) and ``ddim_sample_loop``.
A reintroduced host read of the unsafe count fails the guard. The
hierarchical body reads nothing back with its spans recorded either
(``utils.profiling``).
"""

import functools

import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    PointCloudDiffusionModel, ddim_sample_loop, guided_sample_loop,
    guided_sample_loop_coarse, make_schedule)
from pointcloud_style_transfer_torch.ops import distance
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.utils import profiling

from torch_nosync import NoSyncGuard, SyncRefused, _mark, plain_kernels

N, M, STEPS = 1024, 256, 3
GRID = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)


def small_grids(monkeypatch) -> None:
    for name in ("grid_knn_interpolate_layout", "grid_knn_interpolate"):
        monkeypatch.setattr(P, name, functools.partial(getattr(P, name),
                                                       **GRID))
    monkeypatch.setattr(distance, "grid_knn",
                        functools.partial(P.grid_knn, **GRID))


@pytest.fixture
def setup(monkeypatch):
    torch.manual_seed(0)
    cfg = Config(total_points=N, global_points=M, feature_dim=32,
                 time_embed_dim=16, use_amp=False, knn_backend="grid")
    model = PointCloudDiffusionModel(cfg, device="cpu")
    small_grids(monkeypatch)
    guard = NoSyncGuard()
    plain_kernels(monkeypatch, guard)
    return model, make_schedule(cfg), guard


def inputs(B: int, **draws):
    g = torch.Generator().manual_seed(B)
    ins = dict(src=torch.randn((B, N, 3), generator=g) * 0.8,
               cond=torch.randn((B, N, 3), generator=g) * 0.8,
               fps_starts=torch.randint(0, M, (2, B), generator=g),
               **{k: torch.rand(shape, generator=g) if k != "x_init"
                  else torch.randn(shape, generator=g)
                  for k, shape in draws.items()})
    _mark(ins)
    return ins


def run_guarded(guard, fn):
    P.UNSAFE_COUNTS.clear()
    with guard:
        out = fn()
    assert torch.isfinite(out).all()
    assert len(P.UNSAFE_COUNTS) > 0  # the grid and its ladder ran
    return out


@pytest.mark.parametrize("B", [1, 2])
def test_guided_body_reads_nothing_back(setup, B):
    model, schedule, guard = setup
    ins = inputs(B, x_init=(B, N, 3), cond_priority=(B, N),
                 step_priorities=(STEPS, B, N))
    out = run_guarded(guard, lambda: guided_sample_loop(
        model, schedule, ins["src"], ins["cond"], STEPS, 7.5,
        x_init=ins["x_init"], cond_priority=ins["cond_priority"],
        step_priorities=ins["step_priorities"],
        fps_starts=ins["fps_starts"]))
    assert out.shape == (B, N, 3)
    assert len(P.UNSAFE_COUNTS) == STEPS * B  # one count a cloud and step


@pytest.mark.parametrize("B", [1, 2])
def test_guided_body_reads_nothing_back_while_recording(setup, B):
    with profiling.recording_spans():
        test_guided_body_reads_nothing_back(setup, B)
    steps = [s for s in profiling.spans() if s.name == "sampler.step"]
    assert len(steps) == STEPS


def test_coarse_body_reads_nothing_back(setup):
    model, schedule, guard = setup
    ins = inputs(1, x_init=(1, M, 3), cond_priority=(1, N),
                 src_priority=(1, N))
    out = run_guarded(guard, lambda: guided_sample_loop_coarse(
        model, schedule, ins["src"], ins["cond"], STEPS, 7.5,
        x_init=ins["x_init"], cond_priority=ins["cond_priority"],
        src_priority=ins["src_priority"], fps_starts=ins["fps_starts"]))
    assert out.shape == (1, N, 3)


def test_ddim_body_reads_nothing_back(setup):
    model, schedule, guard = setup
    ins = inputs(1, x_init=(1, N, 3), cond_priorities=(STEPS, 1, N),
                 step_priorities=(STEPS, 1, N))
    out = run_guarded(guard, lambda: ddim_sample_loop(
        model, schedule, ins["src"], ins["cond"], STEPS,
        x_init=ins["x_init"], cond_priorities=ins["cond_priorities"],
        step_priorities=ins["step_priorities"],
        fps_starts=ins["fps_starts"]))
    assert out.shape == (1, N, 3)


def test_guard_refuses_a_host_read_of_the_count(setup, monkeypatch):
    """The ladder's count read back to the host, as it was before the
    ladder moved to the device, fails the guard; a constant's ``tolist``
    (the CPU schedule's) does not."""
    model, schedule, guard = setup
    monkeypatch.setattr(P, "_record_unsafe", lambda counts: (
        P.UNSAFE_COUNTS.extend(int(c) for c in counts)))
    ins = inputs(1, x_init=(1, N, 3), cond_priority=(1, N),
                 step_priorities=(STEPS, 1, N))
    with guard:
        assert torch.arange(3).tolist() == [0, 1, 2]
        with pytest.raises(SyncRefused, match="__int__"):
            guided_sample_loop(
                model, schedule, ins["src"], ins["cond"], STEPS, 7.5,
                x_init=ins["x_init"], cond_priority=ins["cond_priority"],
                step_priorities=ins["step_priorities"],
                fps_starts=ins["fps_starts"])
