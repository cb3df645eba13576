"""The port's end-to-end training proof and the two analyses that read its
checkpoint (``examples/*_torch.py``) on the CPU, held to the JAX package:

* (a) ``e2e_training_proof_torch.main`` at a tiny size (10 pairs, 256 / 64
  points, 3 epochs, 5 sampler steps, 2 test samples): the JAX proof's
  ``loss_curve.json`` keys, one entry an epoch, validation at JAX's epochs,
  the checkpoint directories, and two ``cli.test`` result files under the
  keys of the JAX package's committed ``test_results.json``; each epoch's
  update applied ``lr_for_epoch`` within 1e-5 relative (measured 1.2e-7);
  then ``loss_spike_analysis_torch`` and ``fast_mode_fidelity_torch`` on
  its ``best_model``, and the artifacts' log lines written back as files;
* (b) the 60-epoch proof's learning rates identical in both packages;
* (c) the proof's pairs from seed 42 and their processed split identical
  to the JAX proof's (``tests/test_torch_data.py`` holds one pair a seed
  and a processed split of uniform clouds, not a stream of pairs);
* (d) ``terms_at_t`` against the JAX script's, with the JAX draws passed
  in (tiny widths, Flax-initialised weights; JAX's row minima through the
  TPU kernel in interpret mode, as on the TPU, and the port's plain
  distances in XLA's CPU form, as in the train-step tests: the jnp
  expansion's cancellation alone moved JAX's Chamfer at t = 0 by 5e-5):
  L1 and Chamfer within 1e-5 relative, the eval-step tests' bar, b/a
  within 1e-5;
* (e) the fidelity script's Chamfer against the JAX package's
  ``chamfer_distance`` within 1e-6.
"""

import glob
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.cli import preprocess as port_pre_cli
from pointcloud_style_transfer_torch.training import lr_schedule as port_lr
from pointcloud_style_transfer_tpu.cli import preprocess as jax_pre_cli
from pointcloud_style_transfer_tpu.data import synthetic as jax_syn
from pointcloud_style_transfer_tpu.models import make_schedule
from pointcloud_style_transfer_tpu.models.diffusion import \
    q_sample as jax_q_sample
from pointcloud_style_transfer_tpu.models.losses import \
    diffusion_loss as jax_diffusion_loss
from pointcloud_style_transfer_tpu.ops import index_points as jax_index_points
from pointcloud_style_transfer_tpu.ops.distance import \
    chamfer_distance as jax_chamfer_distance
from pointcloud_style_transfer_tpu.training import lr_schedule as jax_lr

from torch_parity import (models, pallas_vjp_min_sq_dist, pin_jax_encoder,
                          port_schedule, xla_cpu_distances)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import e2e_training_proof as jax_proof  # noqa: E402
import e2e_training_proof_torch as proof  # noqa: E402
import fast_mode_fidelity_torch as fidelity  # noqa: E402
import loss_spike_analysis_torch as spike  # noqa: E402

JAX_ARTIFACTS = ROOT / "docs" / "artifacts" / "e2e_training"
TINY = ["--pairs", "10", "--points", "256", "--global_points", "64",
        "--epochs", "3", "--num_inference_steps", "5", "--test_samples", "2",
        "--device", "cpu"]
LR_RTOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("proof")
    wd, out = root / "work", root / "out"
    res = proof.main(["--workdir", str(wd), "--outdir", str(out), *TINY])
    return wd, out, res


def test_proof_writes_the_jax_artifacts(run):
    wd, out, res = run
    want = json.loads((JAX_ARTIFACTS / "loss_curve.json").read_text())
    curve = json.loads((out / "loss_curve.json").read_text())
    assert list(curve) == list(want)
    for k in ("train", "train_l1", "train_chamfer"):
        assert len(curve[k]) == 3 and np.isfinite(curve[k]).all()
    # JAX's rule: every 5th epoch and the last
    assert curve["val_epochs"] == [0, 2] and len(curve["val"]) == 2
    assert np.isfinite(curve["val"]).all() and res["val_dropped"] == [0, 0]
    ckpts = sorted(os.listdir(wd / "checkpoints" / "e2e_proof"))
    assert ckpts == ["best_model", "ckpt_epoch_0000", "ckpt_epoch_0002"]
    keys = list(json.loads((JAX_ARTIFACTS / "test_20260819_234928"
                            / "test_results.json").read_text())
                ["average_metrics"])
    files = sorted(glob.glob(str(out / "test_*" / "test_results.json"))
                   + glob.glob(str(out / "fast_mode" / "test_*"
                                   / "test_results.json")))
    assert len(files) == 2
    for f in files:
        got = json.loads(Path(f).read_text())["average_metrics"]
        assert list(got) == keys and np.isfinite(list(got.values())).all()
    assert sorted(os.listdir(out / "samples")) == [
        "source.npy", "style_reference.npy", "transferred.npy"]
    # 8 train pairs at batch 2
    assert res["mini_steps"] == 12 and len(res["lr"]) == 3
    for r in res["lr"]:
        assert r["applied"] == pytest.approx(r["lr_for_epoch"], rel=LR_RTOL)


def test_spike_and_fidelity_on_the_proof(run, tmp_path):
    wd, _, res = run
    sp = spike.main(["--checkpoint", res["best_model"], "--data",
                     os.path.join(res["processed"], "val"), "--outdir",
                     str(tmp_path), "--t_step", "250", "--device", "cpu"])
    assert [r["t"] for r in sp["rows"]] == [0, 250, 500, 750, 999]
    assert all(np.isfinite(list(r.values())).all() for r in sp["rows"])
    fd = fidelity.main(["--workdir", str(wd), "--outdir", str(tmp_path),
                        "--num_inference_steps", "5", "--device", "cpu"])
    assert len(fd["rows"]) == 1  # the one val pair of 10
    assert np.isfinite(list(fd["mean"].values())).all()
    assert json.loads((tmp_path / "fidelity.json").read_text()) == fd


def test_artifact_lines_round_trip(run, tmp_path):
    _, out, _ = run
    lines = proof.artifact_lines(str(out))
    log = tmp_path / "chip.log"
    log.write_text("\n".join(["[proof] curve ...", *lines, "done"]) + "\n")
    written = proof.main(["--from_log", str(log), "--outdir",
                          str(tmp_path / "unpacked")])["written"]
    assert len(written) == len(lines) == 8  # 2 JSON + 2 x 2 test + 3 npy
    for path in written:
        rel = os.path.relpath(path, tmp_path / "unpacked")
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(path), np.load(out / rel))
        else:
            assert json.loads(Path(path).read_text()) == json.loads(
                (out / rel).read_text())


def test_proof_learning_rates_identical():
    # the proof's schedule: 60 epochs, warmup 3, base 1e-4, min ratio 0.01
    for epoch in range(60):
        assert port_lr.lr_for_epoch(epoch, 1e-4, 3, 60, 0.01) == \
            jax_lr.lr_for_epoch(epoch, 1e-4, 3, 60, 0.01)


@pytest.mark.parametrize("scene", ["lidar", "shapes"])
def test_proof_pairs_and_split_identical(tmp_path, scene):
    n_pairs, n = 10, 300
    proof.write_pairs(str(tmp_path / "port_raw"), n_pairs, n, scene)
    rng = np.random.default_rng(42)  # the JAX proof's stream
    for i in range(n_pairs):
        if scene == "lidar":
            sim, real = jax_syn.lidar_scene_pair(rng, n)
        else:
            sim = jax_proof.ellipsoid_shell(rng, n)
            real = jax_proof.box_surface(rng, n)
        for side, cloud in (("sim", sim), ("real", real)):
            np.testing.assert_array_equal(
                np.load(tmp_path / "port_raw" / side / f"shape_{i:03d}.npy"),
                cloud)
    raw = ["--sim_dir", str(tmp_path / "port_raw" / "sim"), "--real_dir",
           str(tmp_path / "port_raw" / "real"), "--total_points", "256",
           "--global_points", "64"]
    assert port_pre_cli.main(raw + ["--output_dir", str(tmp_path / "p"),
                                    "--device", "cpu"]) == 0
    assert jax_pre_cli.main(raw + ["--output_dir", str(tmp_path / "j")]) == 0
    files = sorted(p.relative_to(tmp_path / "p")
                   for p in (tmp_path / "p").rglob("*.npz"))
    assert [len(list((tmp_path / "p" / s).glob("*.npz")))
            for s in ("train", "val", "test")] == [8, 1, 1]
    for f in files:
        with np.load(tmp_path / "p" / f) as a, np.load(tmp_path / "j" / f) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")


SPIKE_CFG = dict(total_points=512, global_points=128, feature_dim=32,
                 time_embed_dim=16, use_amp=False)
SPIKE_B, SPIKE_N = 2, 512
SPIKE_RTOL = 1e-5  # loss terms, float32: the eval-step tests' bar


@pytest.fixture(scope="module")
def spike_setup():
    rng = np.random.default_rng(4)
    jmodel, variables, tmodel = models(jax.random.PRNGKey(1), rng,
                                       **SPIKE_CFG)
    sim = rng.standard_normal((SPIKE_B, SPIKE_N, 3)).astype(np.float32)
    real = (rng.standard_normal((SPIKE_B, SPIKE_N, 3)) * 0.3).astype(
        np.float32)
    return jmodel, variables, tmodel, sim, real


def jax_terms_at_t(model, schedule, variables, sim, real, t_scalar, key):
    """The JAX script's ``terms_at_t`` (examples/loss_spike_analysis.py)."""
    cfg = model.config
    B = sim.shape[0]
    k_noise, k_fwd = jax.random.split(key)
    t = jnp.full((B,), t_scalar, jnp.int32)
    noise = jax.random.normal(k_noise, sim.shape, jnp.float32)
    noisy = jax_q_sample(schedule, sim, t, noise)
    pred, idx, _ = model.forward(
        variables, noisy, t, real, key=k_fwd, cond_drop_prob=0.0,
        use_hierarchical=cfg.use_hierarchical, train=False, mutable=False)
    noisy_coarse = jax_index_points(noisy, idx)
    sim_coarse = jax_index_points(sim, idx)
    noise_coarse = jax_index_points(noise, idx)
    a = schedule.sqrt_alphas_cumprod[t][:, None, None]
    b = schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    pred_x0 = (noisy_coarse - b * pred.astype(jnp.float32)) / (a + 1e-8)
    _, loss_dict = jax_diffusion_loss(pred, noise_coarse, pred_x0, sim_coarse,
                                      chamfer_weight=cfg.lambda_chamfer)
    amp = (schedule.sqrt_one_minus_alphas_cumprod[t_scalar]
           / schedule.sqrt_alphas_cumprod[t_scalar])
    return loss_dict["noise_loss"], loss_dict["chamfer_loss"], amp


def jax_forward_draws(key, n):
    """The noise and the eval forward's voxel priorities JAX draws from
    ``key`` in ``terms_at_t`` (its FPS starts are pinned to 0)."""
    k_noise, k_fwd = jax.random.split(key)
    k_vox_c, _, _, k_vox_x, _ = jax.random.split(k_fwd, 5)

    def uniform(k):
        return torch.from_numpy(np.stack([
            np.array(jax.random.uniform(kk, (n,)))
            for kk in jax.random.split(k, SPIKE_B)]))
    noise = torch.from_numpy(np.array(jax.random.normal(
        k_noise, (SPIKE_B, n, 3), jnp.float32)))
    return noise, {"cond_priority": uniform(k_vox_c),
                   "noisy_priority": uniform(k_vox_x),
                   "fps_starts": torch.zeros((2, SPIKE_B), dtype=torch.int64)}


@pytest.mark.parametrize("t", [0, 500, 999])
def test_spike_terms_match_jax(spike_setup, monkeypatch, t):
    jmodel, variables, tmodel, sim, real = spike_setup
    pin_jax_encoder(monkeypatch)
    pallas_vjp_min_sq_dist(monkeypatch)
    jschedule = make_schedule(jmodel.config)
    key = jax.random.PRNGKey(100 + t)
    want = [float(v) for v in jax_terms_at_t(
        jmodel, jschedule, variables, jnp.asarray(sim), jnp.asarray(real),
        jnp.int32(t), key)]
    noise, draws = jax_forward_draws(key, SPIKE_N)
    with xla_cpu_distances():
        got = [float(v) for v in spike.terms_at_t(
            tmodel, port_schedule(jschedule), torch.from_numpy(sim),
            torch.from_numpy(real), t, noise, draws)]
    np.testing.assert_allclose(got[:2], want[:2], rtol=SPIKE_RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    if t == 999:  # the spike: Chamfer amplified by (b/a)^2 ~ 1e7
        assert got[1] > 1e4 * got[0]


def test_fidelity_chamfer_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 300, 3)).astype(np.float32)
    b = rng.standard_normal((2, 200, 3)).astype(np.float32) * 0.8
    want = float(jnp.mean(jax_chamfer_distance(jnp.asarray(a),
                                               jnp.asarray(b))))
    got = fidelity.mean_chamfer(torch.from_numpy(a), torch.from_numpy(b))
    assert abs(got - want) <= 1e-6
