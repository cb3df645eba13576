"""The port's ``parallel/sharded.py`` and ``DiffusionTrainer(mesh_shape=)``
on gloo process groups (``torch_dist``): {data: 2} on 2 ranks and the
point-sharded {data: 2, points: 2} on 4, in train mode, against the port's
single-device ``train_step`` on the global batch with the same draws
(computed on rank 0 of the group, at the ranks' one thread). The sharded
steps replay the single-device step's discrete selections (ReLU gates,
max-pool argmaxes, Chamfer argmins; ``draws["selections"]``, sliced per
cloud): without them 65 gates of one layer flip on 4.3e-6 differences of
their pre-activations at 2 ranks (other summation orders), and a flipped
gate moves the gradient by more than any float32 bar. The condition cloud
is dense (std 0.3), as in ``tests/test_torch_train_step.py``.

* loss within rtol 1e-5 (measured 1.5e-6); gradients within JAX's bars
  (atol 1e-4, rtol 1e-3, ``tests/test_sharding.py``; measured at most 0.40
  of them); BatchNorm running stats and the EMA after the step within 1e-5
  (measured 1.3e-6, 1.9e-6); parameters identical on every rank;
* negative control: each rank's own BatchNorm statistics (the cross-rank
  reduction patched out) must fail those bars (measured: the loss 13.8%
  off, the gradients 28,841 times their bar);
* the eval step's loss terms within rtol 1e-5;
* ``DiffusionTrainer`` with ``mesh_shape={"data": 2}``: one epoch, a finite
  best loss, a ragged validation batch padded, checkpoints and logs from
  rank 0 only, parameters identical on both ranks; resumed with rank 1's
  ``checkpoint_dir`` empty, both ranks take rank 0's checkpoint (epoch,
  best loss, optimizer state, parameters).

And, in one process: a step given all of ``step_draws``' draws takes none
from the generator, and equals the step that takes them from it, bit for
bit.
"""

import json

import numpy as np
import pytest
import torch

import torch_dist
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import PointCloudPreprocessor
from pointcloud_style_transfer_torch.models import (PointCloudDiffusionModel,
                                                    make_schedule)
from pointcloud_style_transfer_torch.training import (ema_init, eval_step,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_torch.training.trainer import step_draws

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3  # tests/test_sharding.py
STATE_TOL = 1e-5  # BatchNorm running stats, EMA
WORLDS = sorted(torch_dist.STEP_MESHES)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    torch.manual_seed(0)
    net = PointCloudDiffusionModel(Config(**torch_dist.STEP_CFG),
                                   device="cpu").net
    rng = np.random.default_rng(2)
    # a dense condition cloud: the ball queries at radius 0.2 find
    # neighbours (tests/test_torch_train_step.py)
    x = {k: (rng.standard_normal((4, 256, 3)) * s).astype(np.float32)
         for k, s in (("sim", 1.0), ("real", 0.3))}
    tmps, started = {}, []
    try:
        for world in WORLDS:
            tmp = tmps[world] = tmp_path_factory.mktemp(f"step{world}")
            torch.save(net.state_dict(), tmp / "weights.pt")
            np.savez(tmp / "inputs.npz", **x)
            if world == 2:
                pre = PointCloudPreprocessor(total_points=256,
                                             global_points=64, seed=0)
                for split, n in (("train", 4), ("val", 3)):  # val: 2 + 1
                    for i in range(n):
                        pts = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
                        pre.save_hierarchical_data(
                            pts, pts[::-1].copy(),
                            str(tmp / "processed" / split), f"{split}_{i}")
            started.append(torch_dist.start_group(torch_dist.step_ranks,
                                                  world, tmp))
    finally:
        ranks = torch_dist.join_groups(*started)
    return {w: (tmps[w], r) for w, r in zip(tmps, ranks)}


def close(got, want, rtol, atol=0.0):
    return np.allclose(got, want, rtol=rtol, atol=atol)


def bars(r, single, prefix):
    """Which of the step's bars the rank's ``prefix`` step meets."""
    return {
        "loss": close(r[f"{prefix}.loss"], single["single.loss"], LOSS_RTOL),
        "grads": close(r[f"{prefix}.grads"], single["single.grads"],
                       GRAD_RTOL, GRAD_ATOL),
        "stats": close(r[f"{prefix}.stats"], single["single.stats"],
                       STATE_TOL, STATE_TOL),
        "ema": close(r[f"{prefix}.ema"], single["single.ema"], STATE_TOL,
                     STATE_TOL)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_loss(groups, world):
    ranks = groups[world][1]
    for r in ranks:
        np.testing.assert_allclose(r["sharded.loss"], ranks[0]["single.loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grads(groups, world):
    ranks = groups[world][1]
    for r in ranks:
        np.testing.assert_allclose(r["sharded.grads"],
                                   ranks[0]["single.grads"], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["stats", "ema"])
def test_sharded_state(groups, world, key):
    ranks = groups[world][1]
    assert np.abs(ranks[0][f"sharded.{key}"]
                  - ranks[0][f"single.{key}"]).max() > 0  # the step moved it
    for r in ranks:
        np.testing.assert_allclose(r[f"sharded.{key}"],
                                   ranks[0][f"single.{key}"],
                                   rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["params", "stats", "ema"])
def test_identical_across_ranks(groups, world, key):
    ranks = groups[world][1]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"sharded.{key}"],
                                      ranks[0][f"sharded.{key}"])


@pytest.mark.parametrize("world", WORLDS)
def test_per_rank_batch_stats_fail(groups, world):
    """Negative control: plain per-rank statistics (what DDP would give)
    miss the global batch's, and the bars above catch it."""
    ranks = groups[world][1]
    for r in ranks:
        met = bars(r, ranks[0], "per_rank_bn")
        assert not met["stats"] and not all(met.values()), met
    assert all(bars(ranks[0], ranks[0], "sharded").values())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eval(groups, world):
    ranks = groups[world][1]
    for r in ranks:
        np.testing.assert_allclose(r["sharded.eval"], ranks[0]["single.eval"],
                                   rtol=LOSS_RTOL)


def test_trainer_mesh_epoch(groups):
    tmp, ranks = groups[2]
    best = [float(r["trainer.best"][0]) for r in ranks]
    assert np.isfinite(best).all() and best[0] == best[1]
    np.testing.assert_array_equal(ranks[0]["trainer.params"],
                                  ranks[1]["trainer.params"])


def test_trainer_resumes_from_rank0(groups):
    """Rank 1's checkpoint directory is empty: it resumes from rank 0's
    checkpoint all the same, optimizer state included."""
    _, ranks = groups[2]
    epoch, best = ranks[0]["resumed.epoch_best"]
    assert epoch == 1 and best == ranks[0]["trainer.best"][0]
    for key in ("resumed.epoch_best", "resumed.opt", "resumed.params"):
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key])
    np.testing.assert_array_equal(ranks[1]["resumed.params"],
                                  ranks[0]["trainer.params"])
    assert np.abs(ranks[0]["trained.opt"]).max() > 0  # moments were saved


def test_trainer_pads_ragged_batch(groups):
    _, ranks = groups[2]
    for r in ranks:  # 3 val clouds at batch 2: the second is padded to 2
        assert r["trainer.val_batches"].tolist() == [2, 1]


def test_trainer_writes_on_rank0_only(groups):
    tmp, _ = groups[2]
    files = [json.loads((tmp / f"trainer_files{r}.json").read_text())
             for r in range(2)]
    assert files[1] == []
    assert any(f.startswith("ckpt/mesh/best_model/") for f in files[0])
    assert any(f.startswith("logs/mesh/") for f in files[0])


CFG = dict(total_points=256, global_points=64, feature_dim=16,
           time_embed_dim=8, num_timesteps=10, use_amp=False,
           gradient_accumulation_steps=1)


@pytest.fixture
def one_thread():
    """Small steps run faster on one thread than on a pool that parallel
    test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kw", [
    {}, {"use_augmentation": True}, {"cond_drop_prob": 0.0},
    {"use_hierarchical": False}], ids=["default", "augment", "no_drop",
                                        "direct"])
def test_step_draws_follow_generator(kw, one_thread):
    torch.manual_seed(0)
    cfg = Config(**{**CFG, **kw})
    rng = np.random.default_rng(3)
    sim = torch.from_numpy(rng.standard_normal((2, 256, 3)).astype(np.float32))
    real = torch.from_numpy(rng.standard_normal((2, 320, 3))
                            .astype(np.float32))
    state = PointCloudDiffusionModel(cfg, device="cpu").net.state_dict()
    runs = []
    for given in (False, True):
        model = PointCloudDiffusionModel(cfg, device="cpu")
        model.net.load_state_dict(state)
        params = dict(model.net.named_parameters())
        opt, ema = make_optimizer(cfg, params), ema_init(params)
        gen = torch.Generator().manual_seed(5)
        draws = (step_draws(model, 2, 256, 320, train=True, generator=gen)
                 if given else None)
        before = gen.get_state()
        terms, _ = train_step(model, make_schedule(cfg), opt, ema, sim, real,
                              1e-3, draws=draws, generator=gen)
        # every draw was given: the step took none from the generator
        assert torch.equal(gen.get_state(), before) == given
        e_draws = (step_draws(model, 2, 256, 320, train=False, generator=gen)
                   if given else None)
        before = gen.get_state()
        e_terms = eval_step(model, make_schedule(cfg), ema, sim, real,
                            draws=e_draws, generator=gen)
        assert torch.equal(gen.get_state(), before) == given
        runs.append((terms, e_terms, torch.cat([p.detach().reshape(-1)
                                                for p in params.values()])))
    (t0, e0, p0), (t1, e1, p1) = runs
    assert {k: float(v) for k, v in t0.items()} == \
        {k: float(v) for k, v in t1.items()}
    assert {k: float(v) for k, v in e0.items()} == \
        {k: float(v) for k, v in e1.items()}
    assert torch.equal(p0, p1)
