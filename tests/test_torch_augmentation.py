"""``data.augmentation.augment_points`` and the augmented training step
against the JAX package.

* ``augment_points`` with the JAX draws carried across (angles, the
  jitter's standard normals, scales, permutations, each recomputed from the
  JAX key's splits): within 1e-6 (a 3x3 rotation and a scale in float32);
* the generator path: deterministic for a seed, the draws taken in the
  documented order, z and xy norms kept by a pure rotation;
* one training mini-step with ``use_augmentation=True`` (both clouds
  augmented with independent draws before the noise is added, as the JAX
  step does): loss terms and gradients at ``test_torch_train_step.py``'s
  bars, and the emitting third mini-step from the JAX state after two
  (parameters, EMA, moments) at that file's bars too. Validation does not
  augment.

XLA's CPU backend fuses the rotation and the jitter into FMAs of its own
order, inside the step differently from a standalone call (optimization
barriers do not stop it): the two packages' augmented clouds differ in the
last bit on ~10-27% of the coordinates (measured), and a last-bit change of
the step's inputs flips one of its discrete selections (measured: the loss
then differs by 0.4-0.7%). So in the step tests the JAX step's
``augment_points`` hands back, through a host callback, the port's
augmentation of the same cloud with the draws of the key it was given
(``port_augment_in_jax``; it checks the cloud), while ``augment_points``
itself is held to JAX's within 1e-6 above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.convert import train_state_to_torch
from pointcloud_style_transfer_torch.data import augment_points
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_torch.training import (compute_losses,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.data import augmentation as jax_aug_module
from pointcloud_style_transfer_tpu.data import \
    augment_points as jax_augment_points
from pointcloud_style_transfer_tpu.models import \
    PointCloudDiffusionModel as JaxModel

from test_torch_train_step import (LR, N, Setup, assert_grads_close,
                                   is_pre_bn_bias, jax_draws, port_draws)
from torch_parity import port_schedule, xla_cpu_distances

AUG = dict(rotation_range=0.05, jitter_std=0.005, scale_min=0.98,
           scale_max=1.02)


def jax_aug_draws(key, shape, rotation_range=0.05, scale_min=0.98,
                  scale_max=1.02, shuffle=False):
    """The draws JAX's ``augment_points`` takes from ``key``."""
    b, n, _ = shape
    k_rot, k_jit, k_scale, k_shuf = jax.random.split(key, 4)
    out = {"angles": jax.random.uniform(k_rot, (b,), minval=-rotation_range,
                                        maxval=rotation_range),
           "jitter": jax.random.normal(k_jit, shape),
           "scales": jax.random.uniform(k_scale, (b, 1, 1), minval=scale_min,
                                        maxval=scale_max).reshape(b)}
    if shuffle:
        out["perms"] = jax.vmap(lambda k: jax.random.permutation(k, n))(
            jax.random.split(k_shuf, b))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("kw", [
    {}, {"shuffle": True}, {"rotation_range": 0.3, "jitter_std": 0.0},
    {"scale_min": 1.0, "scale_max": 1.0}, {"rotation_range": 0.0}])
def test_augment_points_matches_jax(rng, kw):
    pts = rng.standard_normal((3, 257, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    args = dict(AUG, **kw)
    want = np.asarray(jax_augment_points(jnp.asarray(pts), key, **args))
    draws = jax_aug_draws(key, pts.shape, args["rotation_range"],
                          args["scale_min"], args["scale_max"],
                          args.get("shuffle", False))
    got = augment_points(torch.from_numpy(pts), **args, **draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_augment_points_generator_draws(rng):
    pts = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(np.float32))
    a = augment_points(pts, shuffle=True,
                       generator=torch.Generator().manual_seed(1))
    b = augment_points(pts, shuffle=True,
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == pts.shape
    # the documented order: angles, jitter, scales, permutations
    g = torch.Generator().manual_seed(1)
    angles = (torch.rand((2,), generator=g) * 2 - 1) * 0.05
    jitter = torch.randn((2, 64, 3), generator=g)
    scales = 0.98 + torch.rand((2,), generator=g) * (1.02 - 0.98)
    perms = torch.stack([torch.randperm(64, generator=g) for _ in range(2)])
    c = augment_points(pts, shuffle=True, angles=angles, jitter=jitter,
                       scales=scales, perms=perms)
    assert torch.equal(a, c)
    assert (angles.abs() <= 0.05).all()
    assert ((scales >= 0.98) & (scales <= 1.02)).all()


def test_pure_rotation_keeps_z_and_xy_norms(rng):
    pts = torch.from_numpy(rng.standard_normal((1, 128, 3)).astype(np.float32))
    out = augment_points(pts, rotation_range=0.5, jitter_std=0.0,
                         scale_min=1.0, scale_max=1.0,
                         generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(out[..., 2], pts[..., 2], rtol=0, atol=0)
    torch.testing.assert_close(out[..., :2].norm(dim=-1),
                               pts[..., :2].norm(dim=-1), rtol=0, atol=1e-5)


def port_augment_in_jax(s, cfg):
    """An ``augment_points`` for the JAX step: for each key the step splits
    (its fourth key, then one for each cloud), the port's augmentation of
    that cloud with that key's draws, handed back by a host callback."""
    table = {}
    for key in s.keys:
        ka, kb = jax.random.split(jax.random.split(key, 4)[3])
        for cloud, k in ((s.sim, ka), (s.real, kb)):
            out = augment_points(
                torch.from_numpy(cloud),
                rotation_range=cfg.augmentation_rotation_range,
                jitter_std=cfg.augmentation_jitter_std,
                scale_min=cfg.augmentation_scale_min,
                scale_max=cfg.augmentation_scale_max,
                **jax_aug_draws(k, cloud.shape,
                                cfg.augmentation_rotation_range,
                                cfg.augmentation_scale_min,
                                cfg.augmentation_scale_max))
            table[np.asarray(k).tobytes()] = (cloud, out.numpy())

    def augment(points, key, rotation_range, jitter_std, scale_min,
                scale_max, shuffle=False):
        assert (rotation_range, jitter_std, scale_min, scale_max,
                shuffle) == (cfg.augmentation_rotation_range,
                             cfg.augmentation_jitter_std,
                             cfg.augmentation_scale_min,
                             cfg.augmentation_scale_max, False)

        def host(p, k):
            cloud, out = table[np.asarray(k).tobytes()]
            assert np.array_equal(p, cloud)
            return out
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(points.shape, jnp.float32), points,
            key)
    return augment


def step_aug_draws(key, sim_shape, cfg):
    """The augmentation draws of the JAX step's ``compute_losses``: its
    fourth key, split into one for each cloud."""
    ka, kb = jax.random.split(jax.random.split(key, 4)[3])
    kw = dict(rotation_range=cfg.augmentation_rotation_range,
              scale_min=cfg.augmentation_scale_min,
              scale_max=cfg.augmentation_scale_max)
    return {"augment_sim": jax_aug_draws(ka, sim_shape, **kw),
            "augment_real": jax_aug_draws(kb, sim_shape, **kw)}


@pytest.fixture(scope="module")
def aug():
    """test_torch_train_step's setup with ``use_augmentation=True`` on both
    sides; the JAX loss, gradients and three steps computed once."""
    s = Setup(bf16=False)
    s.cfg_kw = dict(s.cfg_kw, use_augmentation=True)
    s.jcfg = JaxConfig(**s.cfg_kw)
    s.jmodel = JaxModel(s.jcfg)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_aug_module, "augment_points",
                   port_augment_in_jax(s, s.jcfg))
        s.run_jax(with_step=True)
    finally:
        mp.undo()
    return s


def draws_for(s, key_index):
    draws = port_draws(jax_draws(s.keys[key_index], N), s.masks)
    draws.update(step_aug_draws(s.keys[key_index], s.sim.shape, s.jcfg))
    return draws


def test_augmented_loss_and_grads_match_jax(aug):
    model = aug.port_model()
    assert model.config.use_augmentation
    draws = draws_for(aug, 0)
    with xla_cpu_distances():
        loss, ld = compute_losses(
            model, port_schedule(aug.jschedule), torch.from_numpy(aug.sim),
            torch.from_numpy(aug.real), train=True,
            cond_drop_prob=model.config.cond_drop_prob,
            chamfer_weight=model.config.lambda_chamfer, draws=draws)
        params = dict(model.net.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
    for k, want in aug.loss_dict.items():
        np.testing.assert_allclose(ld[k].item(), want, rtol=1e-5)
    assert_grads_close(dict(zip(params, grads)), aug.grads)
    # the augmentation moved the inputs: the loss differs from the
    # unaugmented one on the same draws
    plain = PointCloudDiffusionModel(Config(**dict(aug.cfg_kw,
                                                   use_augmentation=False)),
                                     device="cpu")
    plain.net.load_state_dict(dict(model.net.state_dict()))
    with xla_cpu_distances():
        _, ld_plain = compute_losses(
            plain, port_schedule(aug.jschedule), torch.from_numpy(aug.sim),
            torch.from_numpy(aug.real), train=True,
            cond_drop_prob=plain.config.cond_drop_prob,
            chamfer_weight=plain.config.lambda_chamfer,
            draws=draws_for(aug, 0))
    assert ld_plain["total_loss"].item() != ld["total_loss"].item()


def test_augmented_train_step_matches_jax(aug):
    """The emitting third mini-step from the JAX state after two."""
    mid = train_state_to_torch(aug.mid_state)
    model = aug.port_model()
    model.net.load_state_dict({**mid["params"], **mid["batch_stats"]})
    params = dict(model.net.named_parameters())
    opt = make_optimizer(model.config, params)
    opt.load_state_dict(mid["opt_state"])
    ema = {k: v.clone() for k, v in mid["ema_params"].items()}
    draws = draws_for(aug, 2)
    with xla_cpu_distances():
        ld, emit = train_step(model, port_schedule(aug.jschedule), opt, ema,
                              torch.from_numpy(aug.sim),
                              torch.from_numpy(aug.real), LR, draws=draws)
    assert emit
    for k, want in aug.step_loss.items():
        np.testing.assert_allclose(ld[k].item(), want, rtol=1e-5)
    after = aug.after
    for k, p in params.items():
        want = after["params"][k].numpy()
        moved = np.abs(want - mid["params"][k].numpy()).max()
        assert moved <= 2.2 * LR, k
        assert is_pre_bn_bias(k) or moved > 0.5 * LR, k
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2.2 * LR, err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(),
                                   after["ema_params"][k].numpy(), rtol=2.5e-7,
                                   atol=1e-3 * 2.2 * LR, err_msg=k)
    assert_grads_close(opt.state_dict()["mu"], after["opt_state"]["mu"],
                       scale_rtol=2e-4)


def test_validation_does_not_augment(aug):
    """``train=False`` ignores the augmentation (and its draws)."""
    model = aug.port_model()
    draws = draws_for(aug, 0)
    with xla_cpu_distances():
        _, ld = compute_losses(
            model, port_schedule(aug.jschedule), torch.from_numpy(aug.sim),
            torch.from_numpy(aug.real), train=False, cond_drop_prob=0.0,
            chamfer_weight=0.0, draws=draws)
        draws = {k: v for k, v in draws.items()
                 if not k.startswith("augment_")}
        _, ld_none = compute_losses(
            model, port_schedule(aug.jschedule), torch.from_numpy(aug.sim),
            torch.from_numpy(aug.real), train=False, cond_drop_prob=0.0,
            chamfer_weight=0.0, draws=draws)
    assert ld["total_loss"].item() == ld_none["total_loss"].item()
