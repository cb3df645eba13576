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
device, seeded with ``config.seed + 1``, in ``step_draws``' order; the step
functions take any of them as ``draws`` instead, which is how the tests
give both packages the same ones.

With ``config.mesh_shape`` (e.g. {"data": 4}) the steps are data-parallel,
one process per device, through ``parallel/sharded.py``'s ``StepLayout``:
the mesh is made over the default process group (initialised from
torchrun's environment, NCCL on ``cuda``, gloo on ``cpu``), the state is
broadcast from rank 0 (on resume, rank 0's checkpoint), every rank reads
the same batches and takes its slice (a ragged batch is padded by
repeating its last cloud, logged, as the JAX trainer does), and every rank
draws the global batch's draws. Only rank 0 writes checkpoints,
TensorBoard scalars, sample dumps and the log file.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.augmentation import augment_points
from ..device import resolve_device
from ..models import (DiffusionNet, PointCloudDiffusionModel, dtype_of,
                      guided_sample_loop, make_schedule, q_sample)
from ..models.diffusion import DiffusionSchedule
from ..models.losses import diffusion_loss
from ..models.networks import KEEP_PROB
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
                   generator: Optional[torch.Generator] = None,
                   predict_noise: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, LossDict]:
    """(augment ->) q_sample -> forward -> L1 on the gathered coarse noise
    (+ Chamfer of pred_x0 against the clean coarse points). ``draws`` may
    hold any of ``step_draws``' (``augment_sim`` and ``augment_real``, dicts
    of ``augment_points``' draws, used when ``train`` and
    ``use_augmentation``; ``t`` [B]; ``noise`` [B, N, 3]; the draws of
    ``PointCloudDiffusionModel.forward``); ``step_draws`` takes the rest
    from ``generator``. ``draws["selections"]``, a dict, pins the discrete
    selections the gradient follows (the ReLU gates, the style encoder's
    max-pool argmaxes, the Chamfer's argmins): each is replayed from it
    when it holds one, else recorded into it. ``predict_noise`` goes to
    ``PointCloudDiffusionModel.forward``."""
    cfg = model.config
    given = dict(draws or {})
    draws = {**step_draws(model, batch_sim.shape[0], batch_sim.shape[1],
                          batch_real.shape[1], train=train,
                          cond_drop_prob=cond_drop_prob, generator=generator,
                          device=batch_sim.device, given=given), **given}
    aug = {side: draws.pop(f"augment_{side}", None) or {}
           for side in ("sim", "real")}
    if train and cfg.use_augmentation:
        batch_sim, batch_real = (augment_points(
            x, rotation_range=cfg.augmentation_rotation_range,
            jitter_std=cfg.augmentation_jitter_std,
            scale_min=cfg.augmentation_scale_min,
            scale_max=cfg.augmentation_scale_max, generator=generator,
            **aug[side]) for x, side in ((batch_sim, "sim"), (batch_real, "real")))
    dev = batch_sim.device
    t = draws.pop("t").to(dev).long()
    noise = draws.pop("noise").to(dev)
    selections = draws.pop("selections", None)
    noisy = q_sample(schedule, batch_sim, t, noise)

    pred, idx, _ = model.forward(
        noisy, t, batch_real, cond_drop_prob=cond_drop_prob,
        use_hierarchical=cfg.use_hierarchical, train=train,
        generator=generator, selections=selections,
        predict_noise=predict_noise, **draws)
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


def step_draws(model: PointCloudDiffusionModel, batch: int, n_sim: int,
               n_real: int, *, train: bool,
               cond_drop_prob: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               device: torch.device | str | None = None,
               given: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Every draw of one ``compute_losses`` call on a [batch, n_sim, 3] /
    [batch, n_real, 3] pair, taken from ``generator`` in this order: the
    augmentations' (train mode with ``use_augmentation``; sim, then real),
    ``t``, ``noise``, ``cond_priority``, ``fps_starts``,
    ``style_dropout_mask`` (train), ``drop_u`` (when ``cond_drop_prob``,
    by default the config's in train mode and 0 in eval, is positive),
    ``noisy_priority``, ``noise_dropout_masks`` (train). A key of ``given``
    is not drawn. ``compute_losses`` takes its draws here; the
    data-parallel step takes the global batch's and slices them
    (``slice_draws``)."""
    cfg = model.config
    dev = model.device if device is None else torch.device(device)
    B, M = batch, cfg.global_points
    given = given or {}
    if cond_drop_prob is None:
        cond_drop_prob = cfg.cond_drop_prob if train else 0.0

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    d: Dict[str, Any] = {}
    if train and cfg.use_augmentation:
        for side, n in (("sim", n_sim), ("real", n_real)):
            if f"augment_{side}" in given:
                continue
            aug = {}
            if cfg.augmentation_rotation_range > 0:
                aug["angles"] = ((rand(B) * 2 - 1)
                                 * cfg.augmentation_rotation_range)
            if cfg.augmentation_jitter_std > 0:
                aug["jitter"] = torch.randn((B, n, 3), generator=generator,
                                            device=dev)
            lo, hi = cfg.augmentation_scale_min, cfg.augmentation_scale_max
            if not (lo == 1.0 and hi == 1.0):
                aug["scales"] = lo + rand(B) * (hi - lo)
            d[f"augment_{side}"] = aug
    if "t" not in given:
        d["t"] = randint(cfg.num_timesteps, (B,))
    if "noise" not in given:
        d["noise"] = torch.randn((B, n_sim, 3), generator=generator,
                                 device=dev)
    n_cond, n_noisy = n_real, n_sim
    if cfg.use_hierarchical and n_real > M:
        n_cond = M
        if "cond_priority" not in given:
            d["cond_priority"] = rand(B, n_real)
    if "fps_starts" not in given:  # sa1's cloud, then sa1's 512 centroids
        d["fps_starts"] = torch.stack([randint(n, (B,))
                                       for n in (n_cond, 512)])
    if train and "style_dropout_mask" not in given:
        d["style_dropout_mask"] = rand(B, 512) < KEEP_PROB
    if cond_drop_prob > 0 and "drop_u" not in given:
        d["drop_u"] = rand(B, 1)
    if cfg.use_hierarchical and n_sim > M:
        n_noisy = M
        if "noisy_priority" not in given:
            d["noisy_priority"] = rand(B, n_sim)
    if train and "noise_dropout_masks" not in given:
        d["noise_dropout_masks"] = [rand(B, n_noisy, cfg.feature_dim)
                                    < KEEP_PROB for _ in
                                    model.net.noise_predictor.blocks]
    return d


def slice_draws(draws: Dict[str, Any], start: int, stop: int
                ) -> Dict[str, Any]:
    """The draws of clouds [start, stop) of a batch's ``step_draws``, and
    of the selections to replay (``draws["selections"]``, every record
    batch-first; the slice is a new dict, so nothing is recorded into the
    caller's)."""
    def cut(key, v):
        if isinstance(v, dict):
            return {k: cut(k, x) for k, x in v.items()}
        if isinstance(v, list):
            return [x[start:stop] for x in v]
        return v[:, start:stop] if key == "fps_starts" else v[start:stop]
    return {k: cut(k, v) for k, v in draws.items()}


def train_step(model: PointCloudDiffusionModel, schedule: DiffusionSchedule,
               optimizer: MultiStepsAdamW, ema_params: Dict[str, torch.Tensor],
               batch_sim: torch.Tensor, batch_real: torch.Tensor, lr: float,
               *, draws: Optional[Dict[str, Any]] = None,
               generator: Optional[torch.Generator] = None,
               layout=None) -> Tuple[LossDict, bool]:
    """One mini-step: forward in train mode (BatchNorm running stats updated
    in place), loss, backward, the optimizer (``lr``), and the EMA when the
    optimizer really stepped. Returns (detached loss terms, emitted).

    With ``layout`` (``parallel.sharded.StepLayout``, one rank of a mesh)
    the batches are this rank's slices and ``draws`` the global batch's;
    the layout gathers the points, slices the draws, reduces BatchNorm's
    statistics and the gradients over the ranks and averages the loss
    terms, so that the step is this one on the global batch."""
    cfg = model.config
    params = dict(model.net.named_parameters())
    predict_noise, stats = None, contextlib.nullcontext()
    if layout is not None:
        batch_sim, batch_real, draws = layout.localize(
            model, batch_sim, batch_real, draws, generator, train=True)
        predict_noise, stats = (layout.predict_noise(model.net),
                                layout.batch_stats(model.net))
    with stats:
        loss, loss_dict = compute_losses(
            model, schedule, batch_sim, batch_real, train=True,
            cond_drop_prob=cfg.cond_drop_prob,
            chamfer_weight=cfg.lambda_chamfer, draws=draws,
            generator=generator, predict_noise=predict_noise)
        grads = torch.autograd.grad(loss,
                                    [params[k] for k in optimizer.names])
    if layout is not None:
        grads = layout.mean_grads(grads, optimizer.sizes)
    emit = optimizer.step(params, grads, lr)
    if emit:
        ema_update(ema_params, params, cfg.ema_decay)
    return _terms(loss_dict, layout), emit


@torch.no_grad()
def eval_step(model: PointCloudDiffusionModel, schedule: DiffusionSchedule,
              ema_params: Dict[str, torch.Tensor], batch_sim: torch.Tensor,
              batch_real: torch.Tensor, *,
              draws: Optional[Dict[str, Any]] = None,
              generator: Optional[torch.Generator] = None,
              layout=None) -> LossDict:
    """Validation under the EMA weights and the running BatchNorm stats: no
    dropout, no condition drop, L1 only. ``layout`` as for ``train_step``."""
    predict_noise = None
    if layout is not None:
        batch_sim, batch_real, draws = layout.localize(
            model, batch_sim, batch_real, draws, generator, train=False)
        predict_noise = layout.predict_noise(model.net)
    _, loss_dict = call_with_params(
        model.net, ema_params, compute_losses, model, schedule, batch_sim,
        batch_real, train=False, cond_drop_prob=0.0, chamfer_weight=0.0,
        draws=draws, generator=generator, predict_noise=predict_noise)
    return _terms(loss_dict, layout)


def _terms(loss_dict: LossDict, layout) -> LossDict:
    """The detached loss terms; with a layout, the global batch's."""
    if layout is not None:
        return layout.global_terms(loss_dict)
    return {k: v.detach() for k, v in loss_dict.items()}


class DiffusionTrainer:
    def __init__(self, config: Config, resume: bool = True,
                 device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None
        if config.mesh_shape:
            from ..parallel import make_mesh
            self.mesh = make_mesh(dict(config.mesh_shape), self.device.type)
        self.is_main = self.mesh is None or dist.get_rank() == 0
        if self.is_main:
            config.make_dirs()
        self.logger = get_logger("DiffusionTrainer", config.log_dir
                                 if self.is_main else None,
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
            self._resume()
        self._writer = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.last_train_terms: Dict[str, float] = {}
        self.layout = None
        if self.mesh is not None:
            from ..parallel import replicate
            from ..parallel.sharded import StepLayout
            replicate([self.params, self.ema_params,
                       dict(self.model.net.named_buffers())], self.mesh)
            self.layout = StepLayout(self.mesh)
            self.logger.info("Sharded training over mesh %s",
                             dict(zip(self.mesh.mesh_dim_names,
                                      self.mesh.shape)))

    def _resume(self) -> None:
        """Resume from the newest checkpoint. With a mesh, rank 0's: it
        loads it and broadcasts the whole state (optimizer included), the
        epoch and the best loss, so that every rank resumes alike whatever
        its own ``checkpoint_dir`` holds."""
        state, meta, next_epoch = (self.checkpoint_manager.load_latest()
                                   if self.is_main else (None, {}, 0))
        best = meta.get("best_val_loss", float("inf"))
        if self.mesh is not None:
            box = [(state, best, next_epoch)]
            dist.broadcast_object_list(box, src=0, device=self.device)
            state, best, next_epoch = box[0]
        if state is not None:
            self.load_state(state)
            self.start_epoch = next_epoch
            self.best_val_loss = best
            self.logger.info("Resumed from epoch %d", next_epoch)

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

    def _batch(self, x: np.ndarray) -> torch.Tensor:
        """The step's input: the batch on the device, or with a mesh this
        rank's ``data`` slice of it, a ragged batch padded first by
        repeating its last cloud (which slightly overweights that cloud in
        the means; logged)."""
        if self.mesh is None:
            return self._to_device(x)
        from ..parallel import DATA_AXIS, shard_batch
        from ..parallel.mesh import axis_size
        pad = -x.shape[0] % axis_size(self.mesh, DATA_AXIS)
        if pad:
            self.logger.debug("padding ragged batch %d -> %d", x.shape[0],
                              x.shape[0] + pad)
            x = np.concatenate([x] + [x[-1:]] * pad, axis=0)
        return shard_batch(self._to_device(x), self.mesh)

    @property
    def writer(self):
        if not self.is_main:
            return _NoWriter()
        if self._writer is None:
            from ..utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir=os.path.join(
                self.config.log_dir, self.config.experiment_name))
        return self._writer

    # -- steps ---------------------------------------------------------------
    def train_step(self, sim: torch.Tensor, real: torch.Tensor, lr: float,
                   draws: Optional[Dict[str, Any]] = None
                   ) -> Tuple[LossDict, bool]:
        """One mini-step on ``_batch``'s input; with a mesh, ``draws`` are
        the global batch's."""
        return train_step(self.model, self.schedule, self.optimizer,
                          self.ema_params, sim, real, lr, draws=draws,
                          generator=self.generator, layout=self.layout)

    def eval_step(self, sim: torch.Tensor, real: torch.Tensor,
                  draws: Optional[Dict[str, Any]] = None) -> LossDict:
        return eval_step(self.model, self.schedule, self.ema_params, sim,
                         real, draws=draws, generator=self.generator,
                         layout=self.layout)

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
            loss_dict, _ = self.train_step(self._batch(batch["sim_full"]),
                                           self._batch(batch["real_full"]),
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
            loss_dict = self.eval_step(self._batch(batch["sim_full"]),
                                       self._batch(batch["real_full"]))
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
        weights. With a mesh every rank samples (its generator stays in
        step with the others') and rank 0 writes."""
        batch = next(iter(loader))
        sim = self._to_device(batch["sim_full"][:num_samples])
        real = self._to_device(batch["real_full"][:num_samples])
        out = call_with_params(
            self.model.net, self.ema_params, guided_sample_loop, self.model,
            self.schedule, sim, real, num_inference_steps=50,
            guidance_scale=self.config.guidance_scale,
            generator=self.generator)
        if not self.is_main:
            return
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
                if self.is_main:
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


class _NoWriter:
    """The TensorBoard writer of a rank other than 0: writes nothing."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass
