"""The check that decides ``correct`` has to fail: the control (the plain
reference in the precision below the configuration's, in the program's
place) and every fault a cell can have, each planted under a whole run of
the harness on the CPU at a tiny size, where the sound run is correct.

The chip's readings at the cells' own sizes are in ``PERF.md``; the
``cuda`` test below repeats the control's there."""

import os
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench.core import harness

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import readings  # noqa: E402

from test_h100_bench_runs import collect, tiny_cell  # noqa: E402

SEED = 2 ** 33 + 11


def run(cell, seconds=0.2):
    r = harness.Run(cell, SEED, seconds, False, torch.device("cpu"),
                    time.perf_counter(), chips=cell.chips)
    return harness.execute(r, harness.driver_of(cell))


def state_unchanged_sampler(monkeypatch):
    """Each DDIM step hands back the state it was given."""
    from pointcloud_style_transfer_torch.models import samplers
    monkeypatch.setattr(samplers, "ddim_step",
                        lambda schedule, x, *a, **k: x)


def answer_altered(monkeypatch):
    """The answer's points shifted by one row where the sampler returns."""
    import pointcloud_style_transfer_torch.models as models
    sample = models.guided_sample_loop
    monkeypatch.setattr(models, "guided_sample_loop",
                        lambda *a, **k: sample(*a, **k).roll(1, dims=1))


def state_unchanged_step(monkeypatch):
    """The optimizer step counts its mini-step and changes nothing else."""
    from pointcloud_style_transfer_torch.training.optimizer import (
        MultiStepsAdamW)

    def frozen(self, params, grads, lr):
        emit = self.mini_step == self.every_k - 1
        self.mini_step.copy_((self.mini_step + 1) % self.every_k)
        return emit
    monkeypatch.setattr(MultiStepsAdamW, "step", frozen)


def acc_unchanged_step(monkeypatch):
    """From the third mini-step (the first that a card replays) on, the
    step's gradients never reach the optimizer's accumulator."""
    from pointcloud_style_transfer_torch.training.optimizer import (
        MultiStepsAdamW)
    step, calls = MultiStepsAdamW.step, []

    def faulty(self, params, grads, lr):
        calls.append(1)
        if len(calls) > 2:
            grads = self._unflat(self.acc_grads.clone())
        return step(self, params, grads, lr)
    monkeypatch.setattr(MultiStepsAdamW, "step", faulty)


def clip_dropped(monkeypatch):
    """The optimizer applies the accumulated gradient unclipped."""
    from pointcloud_style_transfer_torch.training.optimizer import (
        MultiStepsAdamW)
    step = MultiStepsAdamW.step

    def faulty(self, params, grads, lr):
        self.max_norm = float("inf")
        return step(self, params, grads, lr)
    monkeypatch.setattr(MultiStepsAdamW, "step", faulty)


def slice_dropped(monkeypatch):
    """A thirty-second of the interpolated points never get their noise."""
    readings.slice_dropped(monkeypatch.setattr)


def half_batch(monkeypatch):
    """The loss over the first half of each batch alone."""
    from pointcloud_style_transfer_torch.training import trainer
    losses = trainer.compute_losses

    def half(model, schedule, sim, real, *, draws=None, **kw):
        h = sim.shape[0] // 2
        return losses(model, schedule, sim[:h], real[:h],
                      draws=trainer.slice_draws(draws, 0, h), **kw)
    monkeypatch.setattr(trainer, "compute_losses", half)


@pytest.mark.parametrize("fault", [None, state_unchanged_sampler,
                                   answer_altered, slice_dropped],
                         ids=["sound", "state_unchanged", "answer_altered",
                              "slice_dropped"])
def test_serve_faults(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    line = run(tiny_cell("serve-hier-b1"))
    assert line["correct"] is (fault is None), line["check"]


@pytest.mark.parametrize("fault", [None, state_unchanged_step, half_batch,
                                   acc_unchanged_step, clip_dropped],
                         ids=["sound", "state_unchanged", "half_batch",
                              "acc_unchanged", "clip_dropped"])
def test_train_faults(fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    line = run(tiny_cell("train-hier-b4"), seconds=0.05)
    assert line["correct"] is (fault is None), line["check"]


def sharded_rank(rank, world, port, fault, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    if fault:  # each rank's own share, the others' left at zero
        from pointcloud_style_transfer_torch.parallel import sharded_sampler

        def gather(self, x):
            parts = [x if r == self.me else torch.zeros_like(x)
                     for r in range(self.n)]
            return torch.cat(parts, dim=1)
        sharded_sampler.RowSplit.gather = gather
    cell = tiny_cell("serve-hier-b1-points4", mesh={"points": world})
    r = harness.Run(cell, SEED, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), chips=cell.chips)
    r.state["rank"] = rank
    queue.put((rank, harness.execute(r, harness.driver_of(cell))))


@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "exchange_left_out"])
def test_sharded_exchange_left_out(fault):
    import torch.multiprocessing as mp
    from h100_bench.drivers.serve_sharded import free_port
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    world, port = 4, free_port()  # the cell's own four ranks, on gloo
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, world, port, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got = collect(procs, queue)
    assert got[0]["correct"] is (not fault), got[0]["check"]


def control_numbers(name):
    """The control's compared numbers at a tiny size, and the cell's."""
    cell = tiny_cell(name)
    driver = harness.driver_of(cell)
    r = harness.Run(cell, SEED, 0.0, False, torch.device("cpu"),
                    time.perf_counter(), chips=cell.chips)
    driver.setup(r)
    if cell.traffic["driver"] == "train":
        out = readings.train_readings(r, driver, True)
    else:
        out = readings.serve_readings(r, driver, True)
    return out, cell.check["limits"]


@pytest.mark.parametrize("name", ["serve-hier-b1", "serve-direct-b1",
                                  "train-hier-b4"])
def test_control_fails(name):
    out, limits = control_numbers(name)
    assert any(out["control"][k] > v for k, v in limits.items()), out
    assert all(out["program"][k] <= v for k, v in limits.items()), out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["serve-hier-b1", "serve-direct-b1",
                                  "train-hier-b4"])
def test_control_fails_at_full_size(card, name):
    harness.set_cache_dirs()
    cell = harness.find_cell(harness.load_benchmark(), name)
    driver = harness.driver_of(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        r = harness.Run(cell, seed, 0.0, False, torch.device("cuda", 0),
                        time.perf_counter())
        driver.setup(r)
        if cell.traffic["driver"] == "train":
            out = readings.train_readings(r, driver, True)
        else:
            out = readings.serve_readings(r, driver, True)
        limits = cell.check["limits"]
        assert any(out["control"][k] > v for k, v in limits.items()), out
