"""The port's optimizer, LR schedule and EMA against the JAX trainer's.

The optimizer chain (``training/optimizer.py``, optax's ``MultiSteps`` over
clip -> Adam -> weight decay -> -1, times the LR) gets the same numpy
gradients as optax over seven mini-steps, clipped and unclipped, and is
held within 1e-6 relative on every parameter, moment and accumulator after
each one. The LR table is identical for epochs 0..200 (plain Python
floats). The EMA moves only when the optimizer really stepped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (PointCloudDiffusionModel,
                                                    make_schedule)
from pointcloud_style_transfer_torch.training import (ema_init, ema_update,
                                                      lr_for_epoch,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.training import ema as jax_ema
from pointcloud_style_transfer_tpu.training import \
    lr_schedule as jax_lr_schedule
from pointcloud_style_transfer_tpu.training import trainer as jax_trainer

SHAPES = {"a.weight": (7, 5), "a.bias": (7,), "b.weight": (3, 7),
          "b.scale": (3,)}
# gradient scales per mini-step: the global norm is above the clip (1.0) at
# some steps and below it at others
GRAD_SCALES = (3.0, 0.05, 1.0, 0.02, 4.0, 0.1, 0.5)
LRS = (1e-3, 1e-3, 1e-3, 5e-4, 5e-4, 5e-4, 2e-4)
RTOL = 1e-6


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max() + 1e-30,
                               err_msg=what)


def test_optimizer_chain_matches_optax(rng):
    params0 = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32)
              for k, s in SHAPES.items()} for sc in GRAD_SCALES]

    cfg = JaxConfig()
    tx = jax_trainer.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jp)

    @jax.jit
    def jstep(p, s, g, lr):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, jax.tree_util.tree_map(
            lambda x: x * lr, u)), s

    tp = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    opt = make_optimizer(Config(), tp)
    emits = []
    for step, (g, lr) in enumerate(zip(grads, LRS)):
        jp, jstate = jstep(jp, jstate, {k: jnp.asarray(v)
                                        for k, v in g.items()},
                           jnp.float32(lr))
        emits.append(opt.step(tp, [torch.from_numpy(g[k]) for k in opt.names],
                              lr))
        st = opt.state_dict()
        adam = jstate.inner_opt_state[1]
        assert st["mini_step"] == int(jstate.mini_step)
        assert st["gradient_step"] == int(jstate.gradient_step)
        assert st["count"] == int(adam.count)
        for k in SHAPES:
            close(tp[k], jp[k], f"param {k} after mini-step {step}")
            close(st["mu"][k], adam.mu[k], f"mu {k} after {step}")
            close(st["nu"][k], adam.nu[k], f"nu {k} after {step}")
            close(st["acc_grads"][k], jstate.acc_grads[k],
                  f"acc {k} after {step}")
    assert emits == [False, False, True, False, False, True, False]


def test_optimizer_state_round_trip(rng):
    tp = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in SHAPES.items()}
    opt = make_optimizer(Config(), tp)
    for sc in GRAD_SCALES[:4]:
        opt.step(tp, [torch.full(SHAPES[k], sc) for k in opt.names], 1e-3)
    st = opt.state_dict()
    other = make_optimizer(Config(), {k: v.clone() for k, v in tp.items()})
    other.load_state_dict(st)
    st2 = other.state_dict()
    for key in ("mini_step", "gradient_step", "count"):
        assert st2[key] == st[key]
    for key in ("mu", "nu", "acc_grads"):
        for k in SHAPES:
            assert torch.equal(st2[key][k], st[key][k])


def test_lr_table_identical():
    cfg = Config()
    got = [lr_for_epoch(e, cfg.learning_rate, cfg.warmup_epochs,
                        cfg.num_epochs, cfg.min_lr_ratio) for e in range(201)]
    want = [jax_lr_schedule.lr_for_epoch(e, cfg.learning_rate,
                                         cfg.warmup_epochs, cfg.num_epochs,
                                         cfg.min_lr_ratio)
            for e in range(201)]
    assert got == want
    assert got[0] == cfg.learning_rate  # the epoch-0 quirk
    assert got[1] == cfg.learning_rate / cfg.warmup_epochs


def test_ema_matches_jax(rng):
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in SHAPES.items()}
    e = ema_init(p)
    assert all(e[k] is not p[k] and torch.equal(e[k], p[k]) for k in p)
    p2 = {k: v + 1.5 for k, v in p.items()}
    je = jax_ema.ema_update({k: jnp.asarray(v.numpy()) for k, v in e.items()},
                            {k: jnp.asarray(v.numpy()) for k, v in p2.items()},
                            0.999)
    ema_update(e, p2, 0.999)
    for k in p:
        np.testing.assert_array_equal(e[k].numpy(), np.asarray(je[k]))
    assert not torch.equal(e[k], p[k])  # the shadow is its own copy


def test_ema_moves_only_on_optimizer_steps(rng):
    cfg = Config(total_points=256, global_points=64, feature_dim=16,
                 time_embed_dim=8, use_amp=False)
    model = PointCloudDiffusionModel(cfg, device="cpu")
    params = dict(model.net.named_parameters())
    opt = make_optimizer(cfg, params)
    ema = ema_init(params)
    sim = torch.from_numpy(rng.standard_normal((1, 256, 3)).astype(np.float32))
    real = torch.from_numpy(
        (rng.standard_normal((1, 256, 3)) * 0.3).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    schedule = make_schedule(cfg)
    p0 = {k: v.detach().clone() for k, v in params.items()}
    e0 = {k: v.clone() for k, v in ema.items()}
    for i in range(3):
        terms, emit = train_step(model, schedule, opt, ema, sim, real, 1e-3,
                                 generator=gen)
        assert emit == (i == 2)
        assert all(torch.isfinite(v) for v in terms.values())
        same_p = all(torch.equal(params[k], p0[k]) for k in p0)
        same_e = all(torch.equal(ema[k], e0[k]) for k in e0)
        assert same_p == same_e == (not emit)
    for k in ema:
        want = 0.999 * e0[k] + (1 - 0.999) * params[k].detach()
        torch.testing.assert_close(ema[k], want, rtol=0, atol=0)


@pytest.mark.parametrize("kw, ported", [
    ({"mesh_shape": {"data": 2}}, False),
    ({"use_augmentation": True}, True)])
def test_unported_options_raise(tmp_path, kw, ported):
    """``mesh_shape`` needs as many ranks as its shape holds: in one
    process {"data": 2} raises ``ValueError``, as the JAX ``make_mesh``
    does past the devices it has, before any process group is started
    (the data-parallel trainer itself: tests/test_torch_sharded_step.py);
    ``use_augmentation`` is ported and builds a trainer."""
    import torch.distributed as dist
    from pointcloud_style_transfer_torch.training import DiffusionTrainer
    cfg = Config(checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"),
                 result_dir=str(tmp_path / "r"),
                 processed_data_dir=str(tmp_path / "p"), **kw)
    if ported:
        assert DiffusionTrainer(cfg, resume=False,
                                device="cpu").config.use_augmentation
        return
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        DiffusionTrainer(cfg, resume=False, device="cpu")
    assert not dist.is_initialized()
