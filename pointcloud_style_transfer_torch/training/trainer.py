"""DiffusionTrainer: train/eval steps, accumulation, EMA, checkpoints, early
stop (counterpart of ``pointcloud_style_transfer_tpu/training/trainer.py``).

The same orchestration: AdamW-style chain (``optimizer.py``) with global-norm
clip and 3-step accumulation, per-epoch warmup-cosine LR, EMA advanced only
on real optimizer steps, validation under the EMA weights every
``val_interval`` epochs (L1-only), best-model tracking with patience 20,
periodic sample dumps through ``guided_sample_loop``, TensorBoard scalars.

On the card the Chamfer term's row minima go through the kernels' custom
gradient (``ops.distance.MinSqDist``: the k=1 kNN kernel forward, the
analytic backward). The loss terms are summed on the device and read once
per epoch, so a step never waits for the host.

With ``use_augmentation`` the train step augments both clouds
(``data/augmentation.py``: rotation, jitter, scale) with independent draws
before the noise is added, as the JAX step does; validation does not.

Random draws (augmentation, t, noise, voxel priorities, FPS starts, dropout
masks, the condition-drop uniform) come from one ``torch.Generator`` on the
device, seeded with ``config.seed + 1``; the step functions take any of them
as ``draws`` instead, which is how the tests give both packages the same
ones. Not ported: data-parallel training over ``config.mesh_shape``, which
waits for the port of ``parallel/`` and raises.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.augmentation import augment_points
from ..device import resolve_device
from ..models import (DiffusionNet, PointCloudDiffusionModel, dtype_of,
                      guided_sample_loop, make_schedule, q_sample)
from ..models.diffusion import DiffusionSchedule
from ..models.losses import diffusion_loss
from ..ops import index_points
from ..utils.checkpoint import CheckpointManager
from ..utils.logger import get_logger
from .ema import call_with_params, ema_init, ema_update
from .lr_schedule import lr_for_epoch
from .optimizer import MultiStepsAdamW

LossDict = Dict[str, torch.Tensor]


def make_optimizer(config: Config, params: Dict[str, torch.Tensor]
                   ) -> MultiStepsAdamW:
    """clip -> adam(0.9, 0.95) -> weight decay -> -1 inside MultiSteps(k);
    the LR is applied by the step."""
    return MultiStepsAdamW(params, max_norm=config.gradient_clip,
                           weight_decay=config.weight_decay,
                           every_k=config.gradient_accumulation_steps)


def compute_losses(model: PointCloudDiffusionModel,
                   schedule: DiffusionSchedule, batch_sim: torch.Tensor,
                   batch_real: torch.Tensor, *, train: bool,
                   cond_drop_prob: float, chamfer_weight: float,
                   draws: Optional[Dict[str, Any]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, LossDict]:
    """(augment ->) q_sample -> forward -> L1 on the gathered coarse noise
    (+ Chamfer of pred_x0 against the clean coarse points). ``draws`` may
    hold ``augment_sim`` and ``augment_real`` (dicts of ``augment_points``'
    draws, used when ``train`` and ``use_augmentation``), ``t`` [B],
    ``noise`` [B, N, 3] and any draw of ``PointCloudDiffusionModel.forward``;
    the rest come from ``generator`` (the augmentations', sim then real,
    then t, then noise, then the forward's). ``draws["selections"]``, a
    dict, pins the discrete selections the gradient follows (the ReLU gates,
    the style encoder's max-pool argmaxes, the Chamfer's argmins): each is
    replayed from it when it holds one, else recorded into it."""
    cfg = model.config
    draws = dict(draws or {})
    aug = {side: draws.pop(f"augment_{side}", None) or {}
           for side in ("sim", "real")}
    if train and cfg.use_augmentation:
        batch_sim, batch_real = (augment_points(
            x, rotation_range=cfg.augmentation_rotation_range,
            jitter_std=cfg.augmentation_jitter_std,
            scale_min=cfg.augmentation_scale_min,
            scale_max=cfg.augmentation_scale_max, generator=generator,
            **aug[side]) for x, side in ((batch_sim, "sim"),
                                         (batch_real, "real")))
    B = batch_sim.shape[0]
    dev = batch_sim.device
    t = draws.pop("t", None)
    if t is None:
        t = torch.randint(0, cfg.num_timesteps, (B,), generator=generator,
                          device=dev)
    t = t.to(dev).long()
    noise = draws.pop("noise", None)
    if noise is None:
        noise = torch.randn(batch_sim.shape, generator=generator, device=dev)
    noise = noise.to(dev)
    selections = draws.pop("selections", None)
    noisy = q_sample(schedule, batch_sim, t, noise)

    pred, idx, _ = model.forward(
        noisy, t, batch_real, cond_drop_prob=cond_drop_prob,
        use_hierarchical=cfg.use_hierarchical, train=train,
        generator=generator, selections=selections, **draws)
    backend = "pallas" if cfg.use_pallas else "jnp"
    if idx is None:
        return diffusion_loss(pred, noise, chamfer_weight=0.0)
    noise_coarse = index_points(noise, idx)
    pred_x0_coarse = sim_coarse = None
    if chamfer_weight > 0:
        noisy_coarse = index_points(noisy, idx)
        sim_coarse = index_points(batch_sim, idx)
        a = schedule.sqrt_alphas_cumprod[t][:, None, None]
        b = schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
        pred_x0_coarse = (noisy_coarse - b * pred.float()) / (a + 1e-8)
    return diffusion_loss(pred, noise_coarse, pred_x0_coarse, sim_coarse,
                          chamfer_weight=chamfer_weight, backend=backend,
                          selections=selections)


def train_step(model: PointCloudDiffusionModel, schedule: DiffusionSchedule,
               optimizer: MultiStepsAdamW, ema_params: Dict[str, torch.Tensor],
               batch_sim: torch.Tensor, batch_real: torch.Tensor, lr: float,
               *, draws: Optional[Dict[str, Any]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[LossDict, bool]:
    """One mini-step: forward in train mode (BatchNorm running stats updated
    in place), loss, backward, the optimizer (``lr``), and the EMA when the
    optimizer really stepped. Returns (detached loss terms, emitted)."""
    cfg = model.config
    params = dict(model.net.named_parameters())
    loss, loss_dict = compute_losses(
        model, schedule, batch_sim, batch_real, train=True,
        cond_drop_prob=cfg.cond_drop_prob, chamfer_weight=cfg.lambda_chamfer,
        draws=draws, generator=generator)
    grads = torch.autograd.grad(loss, [params[k] for k in optimizer.names])
    emit = optimizer.step(params, grads, lr)
    if emit:
        ema_update(ema_params, params, cfg.ema_decay)
    return {k: v.detach() for k, v in loss_dict.items()}, emit


@torch.no_grad()
def eval_step(model: PointCloudDiffusionModel, schedule: DiffusionSchedule,
              ema_params: Dict[str, torch.Tensor], batch_sim: torch.Tensor,
              batch_real: torch.Tensor, *,
              draws: Optional[Dict[str, Any]] = None,
              generator: Optional[torch.Generator] = None) -> LossDict:
    """Validation under the EMA weights and the running BatchNorm stats: no
    dropout, no condition drop, L1 only."""
    _, loss_dict = call_with_params(
        model.net, ema_params, compute_losses, model, schedule, batch_sim,
        batch_real, train=False, cond_drop_prob=0.0, chamfer_weight=0.0,
        draws=draws, generator=generator)
    return loss_dict


class DiffusionTrainer:
    def __init__(self, config: Config, resume: bool = True,
                 device: str | torch.device | None = None):
        if config.mesh_shape:
            raise NotImplementedError(
                "mesh_shape (data-parallel training) is not ported yet: it "
                "waits for the port of parallel/")
        self.config = config
        self.device = resolve_device(device)
        config.make_dirs()
        self.logger = get_logger("DiffusionTrainer", config.log_dir,
                                 config.experiment_name)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            net = DiffusionNet(config.feature_dim, config.time_embed_dim,
                               compute_dtype=dtype_of(config),
                               use_kernels=config.use_pallas)
        self.model = PointCloudDiffusionModel(config, self.device, net=net)
        self.schedule = make_schedule(config).to(self.device)
        self.params = dict(self.model.net.named_parameters())
        self.optimizer = make_optimizer(config, self.params)
        self.ema_params = ema_init(self.params)
        n_params = sum(p.numel() for p in self.params.values())
        self.logger.info("Model parameters: %s on %s", f"{n_params:,}",
                         self.device)

        self.checkpoint_manager = CheckpointManager(config.checkpoint_dir,
                                                    config.experiment_name)
        self.best_val_loss = float("inf")
        self.start_epoch = 0
        self.patience_counter = 0
        self.max_patience = 20
        if resume:
            state, meta, next_epoch = self.checkpoint_manager.load_latest()
            if state is not None:
                self.load_state(state)
                self.start_epoch = next_epoch
                self.best_val_loss = meta.get("best_val_loss", float("inf"))
                self.logger.info("Resumed from epoch %d", next_epoch)
        self._writer = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.last_train_terms: Dict[str, float] = {}

    # -- state ---------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """{params, batch_stats, opt_state, ema_params} by state-dict name."""
        return {"params": {k: p.detach() for k, p in self.params.items()},
                "batch_stats": dict(self.model.net.named_buffers()),
                "opt_state": self.optimizer.state_dict(),
                "ema_params": self.ema_params}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        self.model.net.load_state_dict({**state["params"],
                                        **state["batch_stats"]})
        self.optimizer.load_state_dict(state["opt_state"])
        for k, e in self.ema_params.items():
            e.copy_(state["ema_params"][k])

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        if self.device.type == "cuda":  # pinned: the copy does not block
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @property
    def writer(self):
        if self._writer is None:
            from ..utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir=os.path.join(
                self.config.log_dir, self.config.experiment_name))
        return self._writer

    # -- steps ---------------------------------------------------------------
    def train_step(self, sim: torch.Tensor, real: torch.Tensor, lr: float,
                   draws: Optional[Dict[str, Any]] = None
                   ) -> Tuple[LossDict, bool]:
        return train_step(self.model, self.schedule, self.optimizer,
                          self.ema_params, sim, real, lr, draws=draws,
                          generator=self.generator)

    def eval_step(self, sim: torch.Tensor, real: torch.Tensor,
                  draws: Optional[Dict[str, Any]] = None) -> LossDict:
        return eval_step(self.model, self.schedule, self.ema_params, sim,
                         real, draws=draws, generator=self.generator)

    # -- epoch loops ---------------------------------------------------------
    def train_one_epoch(self, loader, epoch: int) -> float:
        cfg = self.config
        lr = lr_for_epoch(epoch, cfg.learning_rate, cfg.warmup_epochs,
                          cfg.num_epochs, cfg.min_lr_ratio)
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        totals, count = None, 0
        t0 = time.time()
        for batch in loader:
            loss_dict, _ = self.train_step(self._to_device(batch["sim_full"]),
                                           self._to_device(batch["real_full"]),
                                           lr)
            # summed on the device; read once per term below
            totals = (dict(loss_dict) if totals is None else
                      {k: totals[k] + v for k, v in loss_dict.items()})
            count += 1
        terms = {k: float(v) / max(count, 1)
                 for k, v in (totals or {}).items()}  # one host sync per term
        self.last_train_terms = terms
        avg = terms.get("total_loss", 0.0)
        self.logger.info(
            "Epoch %d: train loss %.6f (L1 %.4f, CD %.4f) lr %.2e [%.1fs]",
            epoch, avg, terms.get("noise_loss", 0.0),
            terms.get("chamfer_loss", 0.0), lr, time.time() - t0)
        self.writer.add_scalar("Loss/Train", avg, epoch)
        self.writer.add_scalar("Loss/Train_L1", terms.get("noise_loss", 0.0),
                               epoch)
        self.writer.add_scalar("Loss/Train_Chamfer",
                               terms.get("chamfer_loss", 0.0), epoch)
        return avg

    def validate_one_epoch(self, loader, epoch: int) -> float:
        total, count = 0.0, 0
        for batch in loader:
            loss_dict = self.eval_step(self._to_device(batch["sim_full"]),
                                       self._to_device(batch["real_full"]))
            val = float(loss_dict["total_loss"])
            if np.isfinite(val):
                total += val
                count += 1
        avg = total / max(count, 1)
        self.logger.info("Epoch %d: val loss %.6f", epoch, avg)
        self.writer.add_scalar("Loss/Validation", avg, epoch)
        return avg

    def save_sample_results(self, loader, epoch: int, num_samples: int = 2):
        """(original, reference, transferred) npy triplets from the EMA
        weights."""
        batch = next(iter(loader))
        sim = self._to_device(batch["sim_full"][:num_samples])
        real = self._to_device(batch["real_full"][:num_samples])
        out = call_with_params(
            self.model.net, self.ema_params, guided_sample_loop, self.model,
            self.schedule, sim, real, num_inference_steps=50,
            guidance_scale=self.config.guidance_scale,
            generator=self.generator)
        save_dir = os.path.join(self.config.result_dir,
                                self.config.experiment_name,
                                f"epoch_{epoch:04d}")
        os.makedirs(save_dir, exist_ok=True)
        for i in range(sim.shape[0]):
            for name, arr in (("original_sim", sim), ("reference_real", real),
                              ("transferred", out)):
                np.save(os.path.join(save_dir, f"{name}_{i}.npy"),
                        arr[i].cpu().numpy())
        self.logger.info("Sample results saved to %s", save_dir)

    def train(self, train_loader, val_loader) -> float:
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.num_epochs):
            self.train_one_epoch(train_loader, epoch)
            if epoch % cfg.val_interval == 0:
                val_loss = self.validate_one_epoch(val_loader, epoch)
                is_best = val_loss < self.best_val_loss
                if is_best:
                    self.best_val_loss = val_loss
                    self.patience_counter = 0
                    self.logger.info("New best model (val %.6f)", val_loss)
                else:
                    self.patience_counter += 1
                self.checkpoint_manager.save(
                    self.state(), epoch, cfg, is_best=is_best,
                    best_val_loss=self.best_val_loss)
                if self.patience_counter >= self.max_patience:
                    self.logger.info("Early stop: no improvement for %d "
                                     "validations", self.patience_counter)
                    break
                if epoch > 0 and epoch % (cfg.save_interval * 2) == 0:
                    self.save_sample_results(val_loader, epoch)
        self.logger.info("Training done. Best val loss: %.6f",
                         self.best_val_loss)
        self.writer.close()
        return self.best_val_loss
