"""Six training mini-steps of the port's step with the device-side
optimizer state against six of the JAX package's ``make_train_step``
(``jax.jit(train_step, donate_argnums=(0,))``, jitted once for the module):
the step a CUDA graph captures on the card, held to the reference on the
CPU at ``test_torch_train_step.py``'s sizes (2 clouds of 512 points, 128
coarse, feature_dim 32), weights, draws and tolerances.

Each mini-step gets JAX's draws for its own key, the same dropout masks
(JAX traces its step once, so its masks are the same at every step) and
the FPS starts pinned to 0. Accumulation k = 3: the 3rd and 6th mini-steps
emit. The port runs mini-steps 1-3 from the start; then JAX's state after
them is loaded into the port's tensors in place (``load_state_dict``, every
address kept, as a resumed trainer's graph needs) and it runs 4-6. Without
that reload, the first optimizer step's sign noise (below) moves the loss
terms of mini-steps 4-6 by up to 1.9e-5 relative and the running stats by
3.3e-4, past the bars, which are those of one optimizer step.

Tolerances, from ``test_torch_train_step.py`` (float32), after each
optimizer step:

* loss terms within 1e-5 relative at every mini-step;
* the emit pattern and the counters identical, the accumulator reset;
* the parameters within 2.2 lr (at Adam's first steps m / sqrt(v) is about
  sign(g), and a gradient of rounding noise, such as a BatchNorm-cancelled
  bias's, may differ in sign between the packages);
* the EMA within (1 - decay) of that plus two float32 roundings;
* the first moment at the gradients' bars widened by the clip's 2e-4 for
  each of the port's gradients in the accumulator: three here, where
  ``test_torch_train_step.py`` accumulates one (measured 1.13x the
  one-gradient bar, on one element of ``output_mlp.0.weight``);
* BatchNorm running stats within ``STATS_ATOL``.
"""

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.convert import train_state_to_torch
from pointcloud_style_transfer_torch.training import (ema_init,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_tpu.training import ema as jax_ema
from pointcloud_style_transfer_tpu.training import trainer as jax_trainer

from test_torch_train_step import (LR, N, STATS_ATOL, Setup,
                                   assert_grads_close, is_pre_bn_bias,
                                   jax_draws, port_draws)
from torch_parity import (blocked_flax_batchnorm_stats,
                          pallas_vjp_min_sq_dist, pin_jax_encoder,
                          port_schedule, xla_cpu_distances)

STEPS = 6
EMITS = [False, False, True, False, False, True]


@pytest.fixture(scope="module")
def six():
    """The JAX step six times from one jit, its state kept after the 3rd
    and the 6th; the port's six, JAX's state loaded after the 3rd."""
    s = Setup(bf16=False)
    keys = jax.random.split(jax.random.PRNGKey(21), STEPS)
    mp = pytest.MonkeyPatch()
    try:
        pin_jax_encoder(mp)
        pallas_vjp_min_sq_dist(mp)
        blocked_flax_batchnorm_stats(mp)
        mp.setattr(flax_stochastic, "random", s.fake_bernoulli())
        cfg, params = s.jcfg, s.variables["params"]
        tx = jax_trainer.make_optimizer(cfg)
        step = jax_trainer.make_train_step(s.jmodel, s.jschedule, tx, cfg)
        state = {"params": params,
                 "batch_stats": s.variables["batch_stats"],
                 "opt_state": tx.init(params),
                 "ema_params": jax_ema.ema_init(params)}
        sim, real = jnp.asarray(s.sim), jnp.asarray(s.real)
        s.jax_loss, s.jax_counters, s.jax_states = [], [], []
        for i, k in enumerate(keys):
            state, ld = step(state, sim, real, k, jnp.float32(LR))
            s.jax_loss.append({n: float(v) for n, v in ld.items()})
            opt = state["opt_state"]
            s.jax_counters.append((int(opt.mini_step),
                                   int(opt.gradient_step),
                                   int(opt.inner_opt_state[1].count)))
            if i % 3 == 2:
                s.jax_states.append(train_state_to_torch(
                    jax.device_get(state)))
    finally:
        mp.undo()

    model = s.port_model()
    params = dict(model.net.named_parameters())
    s.opt = make_optimizer(model.config, params)
    s.ema = ema_init(params)
    tensors = [*model.net.state_dict(keep_vars=True).values(),
               *s.opt.tensors().values(), *s.ema.values()]
    s.addresses = [t.data_ptr() for t in tensors]
    schedule = port_schedule(s.jschedule)
    lr = torch.tensor(LR, dtype=torch.float32)  # the graph's input
    s.port_loss, s.emits, s.port_counters, s.port_states = [], [], [], []
    s.starts = [{k: v.detach().clone() for k, v in params.items()}]
    for i, k in enumerate(keys):
        if i == 3:  # JAX's state after the first optimizer step, in place
            load_state(model, s.opt, s.ema, s.jax_states[0])
            s.starts.append({k: v.detach().clone() for k, v in
                             params.items()})
        draws = port_draws(jax_draws(k, N), s.masks)
        with xla_cpu_distances():
            ld, emit = train_step(model, schedule, s.opt, s.ema,
                                  torch.from_numpy(s.sim),
                                  torch.from_numpy(s.real), lr, draws=draws)
        s.port_loss.append({n: v.item() for n, v in ld.items()})
        s.emits.append(emit)
        st = s.opt.state_dict()
        s.port_counters.append(tuple(st[c] for c in s.opt.COUNTERS))
        if i % 3 == 2:
            s.port_states.append({
                "params": {k: v.detach().clone() for k, v in params.items()},
                "batch_stats": {k: v.clone() for k, v in
                                model.net.named_buffers()},
                "opt_state": st,
                "ema_params": {k: v.clone() for k, v in s.ema.items()}})
    s.addresses_after = [t.data_ptr() for t in tensors]
    return s


def load_state(model, opt, ema, state):
    """A train state (``train_state_to_torch``) copied into the port's
    tensors, as ``DiffusionTrainer.load_state`` copies a checkpoint."""
    with torch.no_grad():
        model.net.load_state_dict({**state["params"],
                                   **state["batch_stats"]})
        opt.load_state_dict(state["opt_state"])
        for k, e in ema.items():
            e.copy_(state["ema_params"][k])


def test_six_steps_loss_emit_and_counters_match_jax(six):
    for got, want in zip(six.port_loss, six.jax_loss):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert all(e.dtype == torch.bool and e.dim() == 0 for e in six.emits)
    assert [bool(e) for e in six.emits] == EMITS
    # JAX's did_step is mini_step == 0 after the step
    assert [c[0] == 0 for c in six.jax_counters] == EMITS
    assert six.port_counters == six.jax_counters
    assert six.port_counters[-1] == (0, 2, 2)
    assert six.addresses_after == six.addresses


@pytest.mark.parametrize("update", [0, 1])
def test_state_after_each_optimizer_step_matches_jax(six, update):
    got, want = six.port_states[update], six.jax_states[update]
    start = six.starts[update]
    for k, p in got["params"].items():
        w = want["params"][k].numpy()
        moved = np.abs(w - start[k].numpy()).max()
        assert moved <= 2.2 * LR, k
        # the step did move it (a zero-gradient bias moves by its noise only)
        assert is_pre_bn_bias(k) or moved > 0.5 * LR, k
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=2.2 * LR,
                                   err_msg=k)
        # (1 - decay) of the parameter's 2.2 lr, plus two float32 roundings
        np.testing.assert_allclose(got["ema_params"][k].numpy(),
                                   want["ema_params"][k].numpy(),
                                   rtol=2.5e-7, atol=1e-3 * 2.2 * LR,
                                   err_msg=k)
        assert not got["opt_state"]["acc_grads"][k].any()
    assert_grads_close(got["opt_state"]["mu"], want["opt_state"]["mu"],
                       scale_rtol=3 * 2e-4)
    for k in want["batch_stats"]:
        if "running" in k:
            np.testing.assert_allclose(got["batch_stats"][k].numpy(),
                                       want["batch_stats"][k].numpy(),
                                       rtol=0, atol=STATS_ATOL, err_msg=k)
