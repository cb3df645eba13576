"""Data- and point-sharded train and eval steps (counterpart of
``pointcloud_style_transfer_tpu/parallel/sharded.py``).

The JAX steps are the single-device step under GSPMD, so a sharded step
equals the single-device step on the global batch. These do too, with
explicit collectives:

* every rank takes its ``data`` slice of the batch and the same slice of the
  global batch's draws (``trainer.step_draws`` from an identically seeded
  generator, or the injected global ``draws``), so d ranks draw as one
  device does;
* train-mode BatchNorm reduces its sums over the ``data`` ranks before the
  mean and variance (``BatchNorm.reduce_stats``, with a gradient), so its
  statistics and running stats are the global batch's on every rank;
* the gradients are summed over the mesh and divided by the ranks, then
  clipping, accumulation, AdamW and the EMA run identically on every rank;
* the loss terms are all-reduced, so every rank reports the global ones.

With ``shard_points`` (a {data, points} mesh; inputs [B/d, N/p, 3]) the
clouds are first gathered within the ``points`` group. The pointwise
``NoisePredictor`` then runs on this rank's M/p coarse rows (when p divides
M) and its prediction is all-gathered, gradient included. The cross-point
stages run on the gathered cloud, the same on every rank of the group:
augmentation, the voxel downsamples, the style encoder (FPS, ball query,
its BatchNorm statistics) and the loss (L1 and the Chamfer). JAX leaves
that placement to GSPMD.

The steps are ``training.train_step`` / ``eval_step`` themselves, given a
``StepLayout``: it holds this rank's place on the mesh and the collectives
above. A step on a one-rank group takes no collective in BatchNorm, and
equals the single-device step bit for bit.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from ..config import Config
from ..models import PointCloudDiffusionModel
from ..models.diffusion import DiffusionSchedule
from ..models.networks import BatchNorm
from ..training.optimizer import MultiStepsAdamW
from ..training.trainer import eval_step, slice_draws, step_draws, train_step
from .mesh import (DATA_AXIS, POINTS_AXIS, AllGather, AllReduceSum,
                   all_gather, axis_group, axis_rank, axis_size)


# the keys of NoisePredictor's ReLU gates in ``draws["selections"]``
_PREDICTOR_KEYS = ("pe", "block", "out")


def _batch_stats_reduce(group):
    """The sum BatchNorm's statistics take over ``group``."""
    return lambda t: AllReduceSum.apply(t, group)


class StepLayout:
    """Where this rank sits on ``mesh`` (its ``data`` slice and its
    ``points`` group), and what the train and eval steps do about it."""

    def __init__(self, mesh, shard_points: bool = False):
        self.d, self.i = axis_size(mesh, DATA_AXIS), axis_rank(mesh,
                                                              DATA_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.p = axis_size(mesh, POINTS_AXIS) if shard_points else 1
        self.j = axis_rank(mesh, POINTS_AXIS) if shard_points else 0
        self.points_group = (axis_group(mesh, POINTS_AXIS)
                             if self.p > 1 else None)
        self.groups = [g for g, n in ((self.data_group, self.d),
                                      (self.points_group, self.p)) if n > 1]

    def _gather_points(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.p == 1 else all_gather(x, self.points_group, 1)

    def localize(self, model, sim, real, draws, generator, train):
        """(sim, real, draws) of this rank: the clouds gathered within the
        ``points`` group, and its slice of the global batch's draws
        (``draws``, or ``step_draws`` from ``generator``)."""
        sim, real = self._gather_points(sim), self._gather_points(real)
        B = sim.shape[0]
        if draws is None:
            draws = step_draws(model, B * self.d, sim.shape[1],
                               real.shape[1], train=train,
                               generator=generator, device=sim.device)
        return sim, real, slice_draws(draws, self.i * B, (self.i + 1) * B)

    @contextlib.contextmanager
    def batch_stats(self, net: torch.nn.Module):
        """Train-mode BatchNorm statistics over the ``data`` ranks."""
        bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
        if self.d > 1:
            for m in bns:
                m.reduce_stats = _batch_stats_reduce(self.data_group)
        try:
            yield
        finally:
            for m in bns:
                m.reduce_stats = None

    def predict_noise(self, net):
        """``net.predict_noise`` on this rank's coarse rows, all-gathered;
        None (the whole cloud on every rank) without point sharding or when
        p does not divide the rows."""
        if self.p == 1:
            return None

        def predict(x, t, style, train, masks, generator, selections):
            M = x.shape[1]
            if M % self.p:
                return net.predict_noise(x, t, style, train, masks,
                                         generator, selections)
            m = M // self.p
            rows = slice(self.j * m, (self.j + 1) * m)
            if selections is not None:  # the denoiser's gates: its rows
                selections = {k: v[:, rows] if k.startswith(_PREDICTOR_KEYS)
                              else v for k, v in selections.items()}
            local = net.predict_noise(
                x[:, rows], t, style, train,
                None if masks is None else [k[:, rows] for k in masks],
                generator, selections)
            return AllGather.apply(local, self.points_group, 1)
        return predict

    def mean_grads(self, grads: Sequence[torch.Tensor],
                   sizes: Sequence[int]) -> Sequence[torch.Tensor]:
        """The global batch's gradients: each rank's covers its clouds (and,
        point-sharded, its rows; the gathered stages count once per points
        rank), so the mean is the sum over the d * p ranks over d * p."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in self.groups:
            dist.all_reduce(flat, group=g)
        if self.d * self.p > 1:
            flat = flat / (self.d * self.p)
        return flat.split(list(sizes))

    def global_terms(self, terms: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The loss terms averaged over ``data`` (the ``points`` ranks of a
        group hold the same ones), detached."""
        names = list(terms)
        flat = torch.stack([terms[k].detach().float() for k in names])
        if self.d > 1:
            dist.all_reduce(flat, group=self.data_group)
            flat = flat / self.d
        return dict(zip(names, flat.unbind()))


def make_sharded_train_step(model: PointCloudDiffusionModel,
                            schedule: DiffusionSchedule,
                            optimizer: MultiStepsAdamW, config: Config,
                            mesh, shard_points: bool = False):
    """The train step over ``mesh``: ``step(ema_params, batch_sim,
    batch_real, lr, *, draws=None, generator=None) -> (loss terms,
    emitted)``, ``training.train_step`` with a ``StepLayout`` and
    rank-local batches ([B/d, N, 3], or [B/d, N/p, 3] with
    ``shard_points``). ``draws`` are the global batch's; without them they
    come from ``generator``, which every rank seeds alike. Selections to
    replay (``draws["selections"]``, a single-device step's record) are
    sliced like the draws. ``config`` is the model's (JAX's signature)."""
    return functools.partial(train_step, model, schedule, optimizer,
                             layout=StepLayout(mesh, shard_points))


def make_sharded_eval_step(model: PointCloudDiffusionModel,
                           schedule: DiffusionSchedule, config: Config,
                           mesh, shard_points: bool = False):
    """The eval step over ``mesh``: ``step(ema_params, batch_sim,
    batch_real, *, draws=None, generator=None) -> loss terms`` (those of
    ``training.eval_step`` on the global batch, on every rank), with
    rank-local batches as ``make_sharded_train_step`` takes them."""
    return functools.partial(eval_step, model, schedule,
                             layout=StepLayout(mesh, shard_points))
