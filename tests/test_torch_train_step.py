"""One training mini-step of the port vs the JAX package's, hierarchical
branch, 2 clouds of 512 points (128 coarse), feature_dim 32.

Both sides get the same weights, state and draws: t, the noise, the voxel
priorities and the condition-drop uniform are recomputed from JAX's own key
splits; the FPS starts are pinned to 0; the seven dropout keep masks are
drawn with numpy and handed to Flax's Dropout in place of its Bernoulli
draws. The JAX Chamfer runs the TPU row-min kernel's custom VJP in
interpret mode, and the port's plain kernels compute distances in XLA's CPU
FMA form, so both pick the same argmins. Each JAX step is compiled once per
module.

The condition cloud is dense (std 0.3) so that the ball queries at radius
0.2 find neighbours: on a sparse cloud every group is its centroid repeated,
and the BatchNorm's fast variance E[x^2] - E[x]^2 is then all cancellation.
The JAX BatchNorm statistics are summed in blocks
(``blocked_flax_batchnorm_stats``): XLA's one-pass float32 sum over the
32,768 grouped rows is ~50x less accurate than the port's and moved the loss
terms by 2e-5 relative.

Tolerances (float32), each measured on these inputs:

* loss terms within 1e-5 relative (measured 2e-6);
* noise-predictor gradients within 2e-5 of each tensor's largest |g|
  (measured 5e-6);
* the style head's (``fc1``, ``fc2``) within 2e-4 (measured 4.5e-5: its
  input is the PointNet++ feature below);
* gradients of the PointNet++ layers, whose backward runs through nine
  train-mode BatchNorms, each reducing 32,768 rows with cancellation: within
  5e-2 of the tensor's largest |g| (measured 3e-3 on the first step's
  draws, 1.8e-2 on the third's; JAX's own result moves by 2.5e-2 between
  its one-pass and its blocked statistics);
* a Dense bias that feeds a train-mode BatchNorm has a zero gradient in
  exact arithmetic, so both packages return rounding noise: held below 1e-3
  of its weight's largest |g| on both sides (measured 1.4e-4 in JAX, 7e-6 in
  the port);
* the new BatchNorm running stats within STATS_ATOL;
* after a full optimizer step the parameters only to 2 lr: at Adam's first
  step m/sqrt(v) is about sign(g), so a gradient of ~1e-9 whose sign differs
  between the packages moves a weight by 2 lr.
"""

import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.convert import (flax_to_torch,
                                                     params_to_torch,
                                                     train_state_to_torch)
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_torch.training import (compute_losses,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.models import \
    PointCloudDiffusionModel as JaxModel
from pointcloud_style_transfer_tpu.models import make_schedule
from pointcloud_style_transfer_tpu.training import ema as jax_ema
from pointcloud_style_transfer_tpu.training import trainer as jax_trainer

from torch_parity import (blocked_flax_batchnorm_stats, pallas_vjp_min_sq_dist,
                          perturbed, pin_jax_encoder, port_schedule,
                          xla_cpu_distances)

SMALL = dict(total_points=512, global_points=128, feature_dim=32,
             time_embed_dim=16)
B, N, M = 2, 512, 128
LR = 1e-4
GRAD_RTOL = 2e-5  # of each tensor's max |g|; measured 5e-6
HEAD_GRAD_RTOL = 2e-4  # measured 4.5e-5
POINTNET_GRAD_RTOL = 5e-2  # measured <= 1.8e-2 (see the module docstring)
PRE_BN_BIAS_RATIO = 1e-3  # measured <= 1.4e-4 (see the module docstring)
STATS_ATOL = 1e-5  # measured 1.4e-6 on running stats of magnitude ~1
# bf16 compute, port vs JAX (both bf16), measured: the Chamfer term 1.5e-2
# relative (it divides the predicted noise by sqrt(alpha_bar) = 0.063 at
# t = 958), the L1 term 8e-3; bf16 outputs differ by ~2% after 20 layers
# (tests/test_torch_networks.py). The tolerance is about 3x that.
BF16_LOSS_RTOL = 5e-2


def jax_draws(key, n_cond):
    """The draws JAX's compute_losses / model.forward take from ``key``."""
    k_t, k_noise, k_fwd, _ = jax.random.split(key, 4)
    k_vox_c, _, k_drop, k_vox_x, _ = jax.random.split(k_fwd, 5)

    def uniform(k, n):
        return np.stack([np.asarray(jax.random.uniform(kk, (n,)))
                         for kk in jax.random.split(k, B)])
    return {"t": np.asarray(jax.random.randint(k_t, (B,), 0, 1000)),
            "noise": np.asarray(jax.random.normal(k_noise, (B, N, 3),
                                                  jnp.float32)),
            "cond_priority": uniform(k_vox_c, n_cond),
            "noisy_priority": uniform(k_vox_x, N),
            "drop_u": np.asarray(jax.random.uniform(k_drop, (B, 1)))}


def port_draws(draws, masks):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    out["fps_starts"] = torch.zeros((2, B), dtype=torch.int64)
    out["style_dropout_mask"] = torch.from_numpy(masks[0])
    out["noise_dropout_masks"] = [torch.from_numpy(m) for m in masks[1:]]
    return out


class Setup:
    """Weights, data, masks, and the JAX results computed once."""

    def __init__(self, bf16: bool):
        rng = np.random.default_rng(3)
        self.cfg_kw = dict(SMALL, use_amp=bf16)
        jcfg = JaxConfig(**self.cfg_kw)
        self.jcfg = jcfg
        self.jmodel = JaxModel(jcfg)
        v = self.jmodel.init(jax.random.PRNGKey(0), example_points=256)
        self.variables = {"params": perturbed(v["params"], rng),
                          "batch_stats": perturbed(v["batch_stats"], rng)}
        self.jschedule = make_schedule(jcfg)
        self.sim = rng.standard_normal((B, N, 3)).astype(np.float32)
        self.real = (rng.standard_normal((B, N, 3)) * 0.3).astype(np.float32)
        self.masks = [rng.random((B, 512)) < 0.9] + [
            rng.random((B, M, SMALL["feature_dim"])) < 0.9 for _ in range(6)]
        self.keys = jax.random.split(jax.random.PRNGKey(11), 3)

    def fake_bernoulli(self):
        calls = {"n": 0}

        def bernoulli(key, p, shape):
            m = self.masks[calls["n"] % len(self.masks)]
            calls["n"] += 1
            assert tuple(shape) == m.shape and p == pytest.approx(0.9)
            return jnp.asarray(m)
        return types.SimpleNamespace(bernoulli=bernoulli)

    def run_jax(self, with_step: bool):
        mp = pytest.MonkeyPatch()
        try:
            pin_jax_encoder(mp)
            pallas_vjp_min_sq_dist(mp)
            blocked_flax_batchnorm_stats(mp)
            mp.setattr(flax_stochastic, "random", self.fake_bernoulli())
            self._run_jax(with_step)
        finally:
            mp.undo()

    def _run_jax(self, with_step):
        cfg, model, sched = self.jcfg, self.jmodel, self.jschedule
        sim, real = jnp.asarray(self.sim), jnp.asarray(self.real)

        def loss_fn(params, stats, key):
            loss, ld, upd = jax_trainer.compute_losses(
                model, sched, {"params": params, "batch_stats": stats}, sim,
                real, key, train=True, cond_drop_prob=cfg.cond_drop_prob,
                chamfer_weight=cfg.lambda_chamfer)
            return loss, (ld, upd)
        (_, (ld, upd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(self.variables["params"],
                                    self.variables["batch_stats"],
                                    self.keys[0])
        self.loss_dict = {k: float(v) for k, v in ld.items()}
        self.grads = params_to_torch(jax.device_get(grads))
        self.new_stats = flax_to_torch(jax.device_get(
            {"params": self.variables["params"],
             "batch_stats": upd["batch_stats"]}))
        if not with_step:
            return
        tx = jax_trainer.make_optimizer(cfg)
        step = jax.jit(jax_trainer.make_train_step_fn(model, sched, tx, cfg))
        state = {"params": self.variables["params"],
                 "batch_stats": self.variables["batch_stats"],
                 "opt_state": tx.init(self.variables["params"]),
                 "ema_params": jax_ema.ema_init(self.variables["params"])}
        for k in self.keys[:2]:  # two mini-steps: accumulating, no update
            state, _ = step(state, sim, real, k, jnp.float32(LR))
        self.mid_state = jax.device_get(state)
        state, ld = step(state, sim, real, self.keys[2], jnp.float32(LR))
        self.step_loss = {k: float(v) for k, v in ld.items()}
        self.after = train_state_to_torch(jax.device_get(state))

    def port_model(self):
        model = PointCloudDiffusionModel(Config(**self.cfg_kw), device="cpu")
        model.net.load_state_dict(flax_to_torch(self.variables))
        return model


@pytest.fixture(scope="module")
def f32():
    s = Setup(bf16=False)
    s.run_jax(with_step=True)
    return s


@pytest.fixture(scope="module")
def bf16():
    s = Setup(bf16=True)
    s.run_jax(with_step=False)
    return s


def is_pre_bn_bias(name):
    """A PointNet++ Dense bias: a train-mode BatchNorm follows it."""
    return ".linears." in name and name.endswith(".bias")


def assert_grads_close(got, want, scale_rtol=0.0):
    """``got`` vs ``want`` (name -> tensor) at the tolerances above, each
    widened by ``scale_rtol``: for Adam's first moment, the gradient divided
    by the global norm, which the PointNet++ gradients dominate."""
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].detach().numpy(), want[name].numpy()
        if is_pre_bn_bias(name):
            weight = name[: -len("bias")] + "weight"
            bound = PRE_BN_BIAS_RATIO * np.abs(want[weight].numpy()).max()
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, name
            continue
        rtol = (POINTNET_GRAD_RTOL if name.startswith("style_encoder.encoder.")
                else HEAD_GRAD_RTOL if name.startswith("style_encoder.")
                else GRAD_RTOL) + scale_rtol
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=name)


def port_loss(s, key_index=0, model=None):
    model = model or s.port_model()
    draws = port_draws(jax_draws(s.keys[key_index], N), s.masks)
    with xla_cpu_distances():
        loss, ld = compute_losses(
            model, port_schedule(s.jschedule), torch.from_numpy(s.sim),
            torch.from_numpy(s.real), train=True,
            cond_drop_prob=model.config.cond_drop_prob,
            chamfer_weight=model.config.lambda_chamfer, draws=draws)
    return model, loss, ld


def test_loss_and_grads_match_jax(f32):
    model, loss, ld = port_loss(f32)
    assert set(ld) == set(f32.loss_dict) == {"noise_loss", "chamfer_loss",
                                              "total_loss"}
    for k, want in f32.loss_dict.items():
        np.testing.assert_allclose(ld[k].item(), want, rtol=1e-5)
    params = dict(model.net.named_parameters())
    with xla_cpu_distances():
        grads = torch.autograd.grad(loss, list(params.values()))
    assert_grads_close(dict(zip(params, grads)), f32.grads)


def test_batch_stats_update_matches_jax(f32):
    model, _, _ = port_loss(f32)
    got = dict(model.net.named_buffers())
    names = [k for k in f32.new_stats if "running" in k]
    assert len(names) == 18  # 9 BatchNorms x (mean, var)
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), f32.new_stats[k].numpy(),
                                   rtol=0, atol=STATS_ATOL, err_msg=k)
        assert not torch.equal(got[k], flax_to_torch(f32.variables)[k])


def test_bf16_loss_matches_jax(bf16):
    _, _, ld = port_loss(bf16)
    for k, want in bf16.loss_dict.items():
        np.testing.assert_allclose(ld[k].item(), want, rtol=BF16_LOSS_RTOL)


def test_mid_accumulation_step_matches_jax(f32):
    """Start both packages from the JAX state after two mini-steps (carried
    across by ``train_state_to_torch``); the third mini-step emits."""
    mid = train_state_to_torch(f32.mid_state)
    assert mid["opt_state"]["mini_step"] == 2
    assert mid["opt_state"]["count"] == 0
    model = PointCloudDiffusionModel(Config(**f32.cfg_kw), device="cpu")
    model.net.load_state_dict({**mid["params"], **mid["batch_stats"]})
    params = dict(model.net.named_parameters())
    opt = make_optimizer(model.config, params)
    opt.load_state_dict(mid["opt_state"])
    ema = {k: v.clone() for k, v in mid["ema_params"].items()}
    draws = port_draws(jax_draws(f32.keys[2], N), f32.masks)
    with xla_cpu_distances():
        ld, emit = train_step(model, port_schedule(f32.jschedule), opt, ema,
                              torch.from_numpy(f32.sim),
                              torch.from_numpy(f32.real), LR, draws=draws)
    assert emit
    for k, want in f32.step_loss.items():
        np.testing.assert_allclose(ld[k].item(), want, rtol=1e-5)
    after = f32.after
    st = opt.state_dict()
    assert (st["mini_step"], st["gradient_step"], st["count"]) == (
        after["opt_state"]["mini_step"], after["opt_state"]["gradient_step"],
        after["opt_state"]["count"]) == (0, 1, 1)
    for k, p in params.items():
        want = after["params"][k].numpy()
        moved = np.abs(want - mid["params"][k].numpy()).max()
        assert moved <= 2.2 * LR, k
        # the step did move it (a zero-gradient bias moves by its noise only)
        assert is_pre_bn_bias(k) or moved > 0.5 * LR, k
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2.2 * LR, err_msg=k)
        # (1 - decay) of the parameter's 2.2 lr, plus two float32 roundings
        np.testing.assert_allclose(ema[k].numpy(),
                                   after["ema_params"][k].numpy(), rtol=2.5e-7,
                                   atol=1e-3 * 2.2 * LR, err_msg=k)
        assert not st["acc_grads"][k].any()
    # the clip divides every moment by the global norm: measured 4.6e-5
    # relative between the packages
    assert_grads_close(st["mu"], after["opt_state"]["mu"], scale_rtol=2e-4)
    for k in after["batch_stats"]:
        if "running" in k:
            np.testing.assert_allclose(
                dict(model.net.named_buffers())[k].numpy(),
                after["batch_stats"][k].numpy(), rtol=0, atol=STATS_ATOL)
