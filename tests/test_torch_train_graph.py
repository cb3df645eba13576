"""The training steps as one device program each, on the CPU: what a CUDA
graph of ``DiffusionTrainer.train_step`` / ``.eval_step`` needs of the code
around it, held without a card.

* The optimizer keeps its whole state on the device at fixed addresses and
  stays bit-identical to the eager arithmetic it replaced (``OldOptimizer``
  below, the port's optimizer before its counters moved to the device) and
  within ``test_torch_optim.py``'s 1e-6 of optax's ``MultiSteps`` chain.
* ``NoSyncGuard`` (``test_torch_graph_nosync.py``) refuses no host read in
  the train step (forward, backward, optimizer, EMA), the eval step, and
  the pruned kNN with the samplers that run it.
* Every tensor a step's graph reads or writes in place keeps its address
  across steps, a ``state_dict`` round trip and a resume
  (``DiffusionTrainer.step_key`` holds them all).
* The capture runner's outputs (a dict, a tuple, nested), its caches and
  its keys, with the eager run and the capture replaced by CPU stand-ins as
  in ``test_torch_graph_runner.py``: a step routed through the runner on
  the CPU (first call eager, second "captured", later "replayed") is
  bit-identical to the eager step over 6 mini-steps and 2 eval steps.

The CUDA graphs themselves are held on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``'s ``[train graph]``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    PointCloudDiffusionModel, ddim_sample_loop, guided_sample_loop,
    guided_sample_loop_coarse, make_schedule)
from pointcloud_style_transfer_torch.models import capture
from pointcloud_style_transfer_torch.ops import knn_pruned, pruned_knn
from pointcloud_style_transfer_torch.training import (DiffusionTrainer,
                                                      ema_init, ema_update,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_torch.training.trainer import (
    eval_step, flat_draws, nested_draws, step_draws)
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.training import trainer as jax_trainer

from test_torch_graph_nosync import NoSyncGuard, _mark, plain_kernels

TINY = dict(total_points=256, global_points=64, feature_dim=16,
            time_embed_dim=8, num_timesteps=20, use_amp=False, num_workers=0,
            batch_size=2)
SHAPES = {"a.weight": (7, 5), "a.bias": (7,), "b.weight": (3, 7),
          "b.scale": (3,)}
GRAD_SCALES = (3.0, 0.05, 1.0, 0.02, 4.0, 0.1)  # clipped and not
LRS = (1e-3, 1e-3, 1e-3, 5e-4, 5e-4, 5e-4)
EMITS = [False, False, True, False, False, True]
RTOL = 1e-6  # test_torch_optim.py's, against optax


class OldOptimizer:
    """The optimizer's arithmetic as it ran eagerly with Python counters
    (``float(count)`` in the bias corrections, ``* float(emit)``, the state
    rebound on emit): the new one must give the same bits."""

    b1, b2, eps = 0.9, 0.95, 1e-8

    def __init__(self, params, max_norm=1.0, weight_decay=1e-4, every_k=3):
        self.names = list(params)
        n = sum(p.numel() for p in params.values())
        self.max_norm, self.weight_decay, self.every_k = (max_norm,
                                                          weight_decay,
                                                          every_k)
        self.mu, self.nu, self.acc_grads = (torch.zeros(n) for _ in range(3))
        self.mini_step = self.gradient_step = self.count = 0

    def _bc(self, decay, count):
        return 1 - torch.tensor(decay, dtype=torch.float32) ** torch.tensor(
            float(count))

    @torch.no_grad()
    def step(self, params, grads, lr):
        plist = [params[k] for k in self.names]
        g = torch.cat([t.reshape(-1).float() for t in grads])
        n = self.mini_step
        acc = self.acc_grads + (g - self.acc_grads) / (n + 1)
        norm = torch.sqrt(torch.sum(acc * acc))
        clipped = torch.where(norm < self.max_norm, acc,
                              acc / norm * self.max_norm)
        mu = (1 - self.b1) * clipped + self.b1 * self.mu
        nu = (1 - self.b2) * (clipped * clipped) + self.b2 * self.nu
        count = self.count + 1
        update = (mu / self._bc(self.b1, count)) / (
            torch.sqrt(nu / self._bc(self.b2, count)) + self.eps)
        update = update + self.weight_decay * torch.cat(
            [p.reshape(-1) for p in plist])
        emit = n == self.every_k - 1
        update = -1.0 * update * float(emit)
        sizes = [p.numel() for p in plist]
        torch._foreach_add_(plist, [u.view(p.shape) for u, p in zip(
            (update * lr).split(sizes), plist)])
        if emit:
            self.mu, self.nu, self.count = mu, nu, count
            self.acc_grads = torch.zeros_like(acc)
            self.gradient_step += 1
        else:
            self.acc_grads = acc
        self.mini_step = (n + 1) % self.every_k
        return emit


def addresses(opt):
    return {n: t.data_ptr() for n, t in opt.tensors().items()}


def test_optimizer_state_on_device_bit_identical(rng):
    """6 mini-steps at k = 3: the same bits as the eager arithmetic, the
    emit pattern F, F, T, F, F, T as 0-d bool tensors, every state tensor
    at its address (a ``state_dict`` round trip included), and optax's
    ``MultiSteps`` chain within 1e-6."""
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32)
              for k, s in SHAPES.items()} for sc in GRAD_SCALES]
    new_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    old_p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    new, old = make_optimizer(Config(), new_p), OldOptimizer(old_p)
    at = addresses(new)
    assert all(t.dtype == torch.int32 and t.dim() == 0
               for t in (new.mini_step, new.gradient_step, new.count))

    tx = jax_trainer.make_optimizer(JaxConfig())
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)

    @jax.jit
    def jstep(p, s, g, lr):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, jax.tree_util.tree_map(
            lambda x: x * lr, u)), s

    emits = []
    for i, (g, lr) in enumerate(zip(grads, LRS)):
        gl = [torch.from_numpy(g[k]) for k in new.names]
        # the graph's lr is a 0-d float32 tensor: the same product
        emit = new.step(new_p, gl, torch.tensor(lr, dtype=torch.float32)
                        if i % 2 else lr)
        assert emit.dtype == torch.bool and emit.dim() == 0
        emits.append(bool(emit))
        assert old.step(old_p, gl, lr) == bool(emit)
        st = new.state_dict()
        assert [st[c] for c in new.COUNTERS] == [
            old.mini_step, old.gradient_step, old.count]
        for k in SHAPES:
            assert torch.equal(new_p[k], old_p[k]), k
        for key in ("mu", "nu", "acc_grads"):
            assert torch.equal(new._flat(st[key][k] for k in new.names),
                               getattr(old, key)), key
        # a round trip writes into the same tensors
        new.load_state_dict(st)
        assert addresses(new) == at
        jp, jstate = jstep(jp, jstate, {k: jnp.asarray(v)
                                        for k, v in g.items()},
                           jnp.float32(lr))
        adam = jstate.inner_opt_state[1]
        assert (st["mini_step"], st["gradient_step"], st["count"]) == (
            int(jstate.mini_step), int(jstate.gradient_step),
            int(adam.count))
        for k in SHAPES:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(new_p[k].numpy(), want, rtol=RTOL,
                                       atol=RTOL * np.abs(want).max())
            for key, jv in (("mu", adam.mu[k]), ("nu", adam.nu[k]),
                            ("acc_grads", jstate.acc_grads[k])):
                jv = np.asarray(jv)
                np.testing.assert_allclose(
                    st[key][k].numpy(), jv, rtol=RTOL,
                    atol=RTOL * np.abs(jv).max() + 1e-30, err_msg=key)
    assert emits == EMITS


def test_ema_update_predicated_on_the_device(rng):
    """``ema_update(..., emit)`` moves the shadow only where ``emit``
    holds, in place, with the unpredicated update's bits."""
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in SHAPES.items()}
    e = ema_init(p)
    want = ema_init(e)
    ema_update(want, p, 0.99)
    ptrs = {k: t.data_ptr() for k, t in e.items()}
    ema_update(e, {k: v + 1 for k, v in p.items()}, 0.99,
               torch.tensor(False))
    assert all(torch.equal(e[k], p[k]) for k in p)
    ema_update(e, p, 0.99, torch.tensor(True))
    assert all(torch.equal(e[k], want[k]) for k in p)
    assert {k: t.data_ptr() for k, t in e.items()} == ptrs


# -- no host reads -------------------------------------------------------------

def tiny_model(**kw):
    torch.manual_seed(0)
    cfg = Config(**{**TINY, **kw})
    return PointCloudDiffusionModel(cfg, device="cpu"), make_schedule(cfg)


def clouds(B, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, n, 3), generator=g),
            torch.randn((B, n, 3), generator=g) * 0.3)


def followed_state(model, opt, ema, *tensors):
    _mark([dict(model.net.named_parameters()),
           dict(model.net.named_buffers()), opt.tensors(), ema, *tensors])


@pytest.mark.parametrize("augment", [False, True])
def test_train_and_eval_steps_read_nothing_back(monkeypatch, augment):
    """Forward, backward, optimizer and EMA of three mini-steps (the third
    emits), then an eval step, with every input, draw and piece of state
    followed by the guard: nothing is read back to the host."""
    model, schedule = tiny_model(use_augmentation=augment)
    guard = NoSyncGuard()
    plain_kernels(monkeypatch, guard)
    params = dict(model.net.named_parameters())
    opt = make_optimizer(model.config, params)
    ema = ema_init(params)
    sim, real = clouds(1, 256)
    gen = torch.Generator().manual_seed(1)
    lr = torch.tensor(1e-3)
    followed_state(model, opt, ema, sim, real, lr)
    emits = []
    for _ in range(3):
        draws = step_draws(model, 1, 256, 256, train=True, generator=gen)
        _mark(draws)
        with guard:
            terms, emit = train_step(model, schedule, opt, ema, sim, real,
                                     lr, draws=draws)
        emits.append(bool(emit))
        assert all(torch.isfinite(v) for v in terms.values())
    assert emits == [False, False, True]
    draws = step_draws(model, 1, 256, 256, train=False, cond_drop_prob=0.0,
                       generator=gen)
    _mark(draws)
    with guard:
        terms = eval_step(model, schedule, ema, sim, real, draws=draws)
    assert torch.isfinite(terms["total_loss"])


def test_guard_refuses_the_host_emit(monkeypatch):
    """The optimizer's old host branch on ``emit`` fails the guard."""
    model, schedule = tiny_model()
    guard = NoSyncGuard()
    plain_kernels(monkeypatch, guard)
    params = dict(model.net.named_parameters())
    opt = make_optimizer(model.config, params)
    ema = ema_init(params)
    followed_state(model, opt, ema)
    own = opt.step
    monkeypatch.setattr(opt, "step", lambda *a: bool(own(*a)))
    sim, real = clouds(1, 256)
    draws = step_draws(model, 1, 256, 256, train=True,
                       generator=torch.Generator().manual_seed(1))
    with guard, pytest.raises(AssertionError, match="__bool__"):
        train_step(model, schedule, opt, ema, sim, real, 1e-3, draws=draws)


def pruned_paused(monkeypatch, guard):
    """The pruned pass's plain version with the guard paused, its outputs
    followed (``plain_kernels``' rule for the other kernels)."""
    own = pruned_knn.knn_pruned_pass

    @functools.wraps(own)
    def call(*args, **kwargs):
        with guard.pause():
            out = own(*args, **kwargs)
        _mark(out)
        return out
    monkeypatch.setattr(pruned_knn, "knn_pruned_pass", call)


def test_pruned_knn_reads_nothing_back(monkeypatch):
    """The pruned kNN's driver (Morton sort, padding, window, box bounds,
    the two passes, the scatter back) reads nothing back to the host, and
    gives the plain passes' result."""
    guard = NoSyncGuard()
    pruned_paused(monkeypatch, guard)
    q, r = clouds(2, 1500, seed=3)
    r = r[:, :1100] * 3
    _mark([q, r])
    with guard:
        d, i = knn_pruned(q, r, 3)
    dd = ((q[:, :, None] - r[:, None]) ** 2).sum(-1)
    want = torch.topk(dd, 3, dim=-1, largest=False).values
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)
    assert (i >= 0).all() and (i < 1100).all()
    torch.testing.assert_close(torch.gather(dd, 2, i.long()), want,
                               rtol=1e-5, atol=1e-6)


SAMPLER_N, SAMPLER_M, STEPS = 1024, 256, 2


@pytest.mark.parametrize("sampler", ["guided", "coarse", "ddim"])
def test_pruned_samplers_read_nothing_back(monkeypatch, sampler):
    """The three samplers on ``"pallas_pruned"``, which the card now
    captures like the other backends: no host read in their bodies."""
    model, schedule = tiny_model(total_points=SAMPLER_N,
                                 global_points=SAMPLER_M, feature_dim=32,
                                 time_embed_dim=16,
                                 knn_backend="pallas_pruned")
    guard = NoSyncGuard()
    plain_kernels(monkeypatch, guard)
    pruned_paused(monkeypatch, guard)
    calls = []
    own = pruned_knn._pruned_knn_single
    monkeypatch.setattr(pruned_knn, "_pruned_knn_single",
                        lambda *a, **k: calls.append(1) or own(*a, **k))
    g = torch.Generator().manual_seed(4)
    src, cond = (torch.randn((1, SAMPLER_N, 3), generator=g) * 0.8
                 for _ in range(2))
    fps = torch.randint(0, SAMPLER_M, (2, 1), generator=g)
    n = SAMPLER_N
    if sampler == "guided":
        ins = dict(x_init=torch.randn((1, n, 3), generator=g),
                   cond_priority=torch.rand((1, n), generator=g),
                   step_priorities=torch.rand((STEPS, 1, n), generator=g))
        run = functools.partial(guided_sample_loop, model, schedule, src,
                                cond, STEPS, 7.5, fps_starts=fps, **ins)
    elif sampler == "coarse":
        ins = dict(x_init=torch.randn((1, SAMPLER_M, 3), generator=g),
                   cond_priority=torch.rand((1, n), generator=g),
                   src_priority=torch.rand((1, n), generator=g))
        run = functools.partial(guided_sample_loop_coarse, model, schedule,
                                src, cond, STEPS, 7.5, fps_starts=fps, **ins)
    else:
        ins = dict(x_init=torch.randn((1, n, 3), generator=g),
                   cond_priorities=torch.rand((STEPS, 1, n), generator=g),
                   step_priorities=torch.rand((STEPS, 1, n), generator=g))
        run = functools.partial(ddim_sample_loop, model, schedule, src, cond,
                                STEPS, fps_starts=fps, **ins)
    _mark([src, cond, fps, ins])
    with guard:
        out = run()
    assert out.shape == (1, n, 3) and torch.isfinite(out).all()
    assert len(calls) == (1 if sampler == "coarse" else STEPS)


# -- the runner's outputs, caches and keys -------------------------------------

class Owner:
    pass


class FakeGraph:
    """A stand-in for a CUDA graph of a step: the capture runs nothing that
    lasts (the state the body writes is put back), a replay runs the body
    on the static inputs and copies its outputs into the static ones."""

    def __init__(self, body, static, output):
        self.body, self.static, self.output = body, static, output

    def replay(self):
        new = self.body(self.static)
        for o, n in zip(tree_flatten(self.output)[0],
                        tree_flatten(new)[0]):
            o.copy_(n)


@pytest.fixture
def runner(monkeypatch):
    """``run_captured`` with CPU stand-ins for its eager run and its
    capture; ``state`` holds the tensors a capture must leave as they
    were."""
    calls = {"eager": 0, "capture": 0, "state": []}
    monkeypatch.setattr(capture, "_ENTRIES", {})

    def eager(body, inputs):
        calls["eager"] += 1
        return body(inputs)

    def fake_capture(body, inputs):
        calls["capture"] += 1
        static = {n: t.clone() for n, t in inputs.items()}
        saved = [t.detach().clone() for t in calls["state"]]
        output = tree_map(lambda t: t.detach().clone(), body(static))
        with torch.no_grad():
            for t, s in zip(calls["state"], saved):
                t.copy_(s)
        return capture._Graph(FakeGraph(body, static, output), static,
                              output, None, {})
    monkeypatch.setattr(capture, "_eager", eager)
    monkeypatch.setattr(capture, "_capture", fake_capture)
    return calls


def test_runner_returns_each_output_cloned(runner):
    owner = Owner()

    def body(ins):
        return {"a": ins["x"] + 1, "b": (ins["x"] * 2, ins["x"] > 1)}
    outs = [capture.run_captured(("k",), body,
                                 {"x": torch.full((2,), float(i))}, owner,
                                 cache="step") for i in range(3)]
    assert runner["eager"] == 1 and runner["capture"] == 1
    for i, out in enumerate(outs):
        assert torch.equal(out["a"], torch.full((2,), i + 1.0))
        assert torch.equal(out["b"][0], torch.full((2,), 2.0 * i))
        assert torch.equal(out["b"][1], torch.full((2,), i > 1))
    outs[-1]["a"].zero_()  # a clone, not the graph's buffer
    again = capture.run_captured(("k",), body, {"x": torch.ones(2)}, owner,
                                 cache="step")
    assert torch.equal(again["a"], torch.full((2,), 2.0))


def test_caches_do_not_evict_each_other(runner):
    owner = Owner()

    def body(ins):
        return ins["x"]
    x = {"x": torch.zeros(1)}
    for kind in ("train", "eval"):
        capture.run_captured((kind,), body, x, owner, cache="step")
        capture.run_captured((kind,), body, x, owner, cache="step")
    for key in range(capture.CACHE_SIZE + 1):  # the samplers' keys
        capture.run_captured((key,), body, x, owner)
    assert len(capture._ENTRIES["sampler"]) == capture.CACHE_SIZE
    assert runner["capture"] == 2
    for kind in ("train", "eval"):  # still captured: replays
        capture.run_captured((kind,), body, x, owner, cache="step")
    assert runner == {"eager": 2 + capture.CACHE_SIZE + 1, "capture": 2,
                      "state": []}


def tiny_trainer(tmp_path, name="toy"):
    cfg = Config(**TINY, gradient_accumulation_steps=3,
                 experiment_name=name,
                 checkpoint_dir=str(tmp_path / "ckpt"),
                 log_dir=str(tmp_path / "logs"),
                 result_dir=str(tmp_path / "results"))
    return DiffusionTrainer(cfg, resume=False, device="cpu")


def trainer_state(t):
    return [*t.params.values(), *t.model.net.buffers(),
            *t.optimizer.tensors().values(), *t.ema_params.values()]


def test_step_key_rules(tmp_path, runner, monkeypatch):
    """A step's key holds every tensor it reads in place: rebinding one
    (here the first moment) makes the next call a new key, eager again;
    train and eval keys differ; a ragged batch has its own key."""
    t = tiny_trainer(tmp_path)
    runner["state"] = trainer_state(t)
    monkeypatch.setattr(t, "_graphed", lambda draws: True)
    sim, real = clouds(1, 256)
    for _ in range(2):
        t.train_step(sim, real, 1e-3)
    assert (runner["eager"], runner["capture"]) == (1, 1)
    assert t.step_key("train") != t.step_key("eval")
    t.train_step(*clouds(1, 200), 1e-3)  # another shape: its own key
    assert (runner["eager"], runner["capture"]) == (2, 1)
    key = t.step_key("train")
    t.optimizer.mu = t.optimizer.mu.clone()
    assert t.step_key("train") != key
    t.train_step(sim, real, 1e-3)
    assert (runner["eager"], runner["capture"]) == (3, 1)
    assert set(capture._ENTRIES) == {"step"}


def test_routed_steps_match_eager_and_keep_addresses(tmp_path, runner,
                                                     monkeypatch):
    """Two trainers from one seed: one takes the eager steps, the other
    goes through the runner (its first call eager, its second captured,
    then replays; draws taken first, flattened into inputs). Over 6
    mini-steps and 2 eval steps they agree bit for bit (terms, emit, every
    parameter, buffer, optimizer and EMA tensor) and the routed trainer's
    key, which holds the address of every tensor its graphs read, never
    changes: through the steps, a ``state()`` / ``load_state`` round trip
    and a resume from its checkpoint into a new trainer, whose state then
    equals it."""
    eager, routed = tiny_trainer(tmp_path / "a"), tiny_trainer(tmp_path / "b")
    runner["state"] = trainer_state(routed)
    monkeypatch.setattr(routed, "_graphed", lambda draws: True)
    keys = {k: routed.step_key(k) for k in ("train", "eval")}
    lr = routed.lr_tensor(1e-3)
    emits = []
    for i in range(6):
        sim, real = clouds(1, 256, seed=i)
        te, ee = eager.train_step(sim, real, 1e-3)
        tr, er = routed.train_step(sim, real, lr)
        emits.append(bool(er))
        assert bool(ee) == bool(er)
        assert all(torch.equal(te[k], tr[k]) for k in te)
        assert {k: routed.step_key(k) for k in keys} == keys
    assert emits == EMITS
    for i in range(2):
        sim, real = clouds(1, 256, seed=10 + i)
        te, tr = eager.eval_step(sim, real), routed.eval_step(sim, real)
        assert all(torch.equal(te[k], tr[k]) for k in te)
    assert (runner["eager"], runner["capture"]) == (2, 2)
    for a, b in zip(trainer_state(eager), trainer_state(routed)):
        assert torch.equal(a, b)

    routed.load_state(routed.state())
    assert {k: routed.step_key(k) for k in keys} == keys
    routed.checkpoint_manager.save(routed.state(), 0, routed.config,
                                   is_best=True, best_val_loss=1.0)
    resumed = tiny_trainer(tmp_path / "b")
    before = {k: resumed.step_key(k) for k in keys}
    resumed._resume()
    assert {k: resumed.step_key(k) for k in keys} == before
    assert resumed.start_epoch == 1
    for a, b in zip(trainer_state(routed), trainer_state(resumed)):
        assert torch.equal(a, b)


def test_draws_flatten_round_trip():
    model, _ = tiny_model(use_augmentation=True)
    d = step_draws(model, 2, 256, 256, train=True,
                   generator=torch.Generator().manual_seed(0))
    flat = flat_draws(d)
    assert all(isinstance(t, torch.Tensor) for t in flat.values())
    assert "augment_sim.jitter" in flat and "noise_dropout_masks.5" in flat
    back = nested_draws(flat)
    assert list(back) == list(d)
    for k, v in d.items():
        if isinstance(v, dict):
            assert all(torch.equal(v[n], back[k][n]) for n in v)
        elif isinstance(v, list):
            assert len(v) == len(back[k]) and all(
                torch.equal(a, b) for a, b in zip(v, back[k]))
        else:
            assert torch.equal(v, back[k])
