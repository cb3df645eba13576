"""The port's trainer and its CLIs on the CPU at a tiny size: epochs,
validation, the checkpoint directory contract (names, ``meta.json``,
``best_model``), resume, sample dumps, and ``cli.preprocess`` ->
``cli.train`` -> ``cli.inference`` -> ``cli.compare`` with ``--device cpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.cli import compare as compare_cli
from pointcloud_style_transfer_torch.cli import inference as infer_cli
from pointcloud_style_transfer_torch.cli import preprocess as pre_cli
from pointcloud_style_transfer_torch.cli import train as train_cli
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import create_dataloaders
from pointcloud_style_transfer_torch.training import DiffusionTrainer
from pointcloud_style_transfer_torch.utils.checkpoint import (
    CheckpointManager, load_for_inference)
from pointcloud_style_transfer_tpu.cli import compare as jax_compare_cli

TINY = dict(total_points=256, global_points=64, feature_dim=16,
            time_embed_dim=8, num_timesteps=20, use_amp=False, num_workers=0,
            val_interval=1, warmup_epochs=1, gradient_accumulation_steps=2)


def write_clouds(tmp_path, n_files=5, n_points=300):
    rng = np.random.default_rng(0)
    for side in ("sim", "real"):
        (tmp_path / side).mkdir()
        for i in range(n_files):
            np.save(tmp_path / side / f"cloud_{i:03d}.npy",
                    rng.uniform(-5, 5, (n_points, 3)).astype(np.float32))
    return str(tmp_path / "sim"), str(tmp_path / "real")


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    sim, real = write_clouds(root)
    out = root / "processed"
    assert pre_cli.main(["--sim_dir", sim, "--real_dir", real,
                         "--output_dir", str(out), "--total_points", "256",
                         "--global_points", "64", "--device", "cpu"]) == 0
    return str(out)


def tiny_config(tmp_path, processed, **kw):
    return Config(**{**TINY, **kw}, experiment_name="toy",
                  processed_data_dir=processed,
                  checkpoint_dir=str(tmp_path / "ckpt"),
                  log_dir=str(tmp_path / "logs"),
                  result_dir=str(tmp_path / "results"), batch_size=2)


def test_train_checkpoints_and_resume(tmp_path, processed):
    cfg = tiny_config(tmp_path, processed, num_epochs=2)
    train_loader, val_loader = create_dataloaders(cfg)
    assert len(train_loader) == 2  # 4 train files, batch 2
    trainer = DiffusionTrainer(cfg, resume=False, device="cpu")
    p0 = {k: v.detach().clone() for k, v in trainer.params.items()}
    best = trainer.train(train_loader, val_loader)
    assert np.isfinite(best) and best == trainer.best_val_loss
    terms = trainer.last_train_terms
    assert set(terms) == {"noise_loss", "chamfer_loss", "total_loss"}
    assert all(np.isfinite(v) for v in terms.values())
    # 2 epochs x 2 mini-steps, accumulation 2: two optimizer steps
    st = trainer.optimizer.state_dict()
    assert (st["gradient_step"], st["count"], st["mini_step"]) == (2, 2, 0)
    assert any(not torch.equal(trainer.params[k], p0[k]) for k in p0)

    base = tmp_path / "ckpt" / "toy"
    assert sorted(os.listdir(base)) == ["best_model", "ckpt_epoch_0000",
                                        "ckpt_epoch_0001"]
    for d in ("ckpt_epoch_0001", "best_model"):
        assert sorted(os.listdir(base / d)) == ["meta.json", "state.pt"]
    meta = json.loads((base / "ckpt_epoch_0001" / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["best_val_loss"] == best
    assert Config.from_dict(meta["config"]) == cfg
    state, _ = CheckpointManager.restore(str(base / "ckpt_epoch_0001"))
    assert set(state) == {"params", "batch_stats", "opt_state", "ema_params"}

    resumed = DiffusionTrainer(cfg, resume=True, device="cpu")
    assert resumed.start_epoch == 2 and resumed.best_val_loss == best
    for k, v in trainer.params.items():
        assert torch.equal(resumed.params[k], v)
        assert torch.equal(resumed.ema_params[k], trainer.ema_params[k])
    assert resumed.optimizer.state_dict()["count"] == 2
    for k, v in trainer.model.net.named_buffers():
        assert torch.equal(dict(resumed.model.net.named_buffers())[k], v)
    assert resumed.train(train_loader, val_loader) == best  # nothing to run

    config, model = load_for_inference(str(base / "best_model"), "cpu")
    assert config == cfg
    best_state, _ = CheckpointManager.restore(str(base / "best_model"))
    for k, v in model.net.named_parameters():
        assert torch.equal(v, best_state["ema_params"][k])


def test_checkpoint_manager_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "x", max_to_keep=2)
    assert mgr.load_latest() == (None, {}, 0)
    for e in (0, 3, 7):
        mgr.save({"params": {"w": torch.full((2,), float(e))}}, e, Config(),
                 is_best=(e == 3), best_val_loss=float(e))
    assert mgr.list_epochs() == [3, 7]
    state, meta, nxt = mgr.load_latest()
    assert nxt == 8 and meta["epoch"] == 7
    assert torch.equal(state["params"]["w"], torch.full((2,), 7.0))
    best, best_meta = CheckpointManager.restore(mgr.best_dir)
    assert best_meta["epoch"] == 3


def test_eval_step_and_samples(tmp_path, processed):
    cfg = tiny_config(tmp_path, processed, num_epochs=1)
    _, val_loader = create_dataloaders(cfg)
    trainer = DiffusionTrainer(cfg, resume=False, device="cpu")
    batch = next(iter(val_loader))
    sim = torch.from_numpy(batch["sim_full"])
    real = torch.from_numpy(batch["real_full"])
    a = trainer.eval_step(sim, real)
    assert set(a) == {"noise_loss", "total_loss"}  # L1 only
    assert torch.equal(a["noise_loss"], a["total_loss"])
    trainer.save_sample_results(val_loader, 3, num_samples=1)
    out = tmp_path / "results" / "toy" / "epoch_0003"
    assert sorted(os.listdir(out)) == ["original_sim_0.npy",
                                       "reference_real_0.npy",
                                       "transferred_0.npy"]
    res = np.load(out / "transferred_0.npy")
    assert res.shape == (256, 3) and np.isfinite(res).all()


def test_cli_train_inference_compare(tmp_path, processed, monkeypatch,
                                     capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_cli, "Config",
                        lambda: Config(**TINY, num_epochs=1))
    assert train_cli.main(["--experiment_name", "clitest", "--data_dir",
                           processed, "--batch_size", "1", "--val_interval",
                           "1", "--device", "cpu"]) == 0
    best = tmp_path / "checkpoints" / "clitest" / "best_model"
    assert (best / "state.pt").exists()

    rng = np.random.default_rng(1)
    src, ref, out = (tmp_path / f for f in ("src.npy", "ref.npy", "o.npy"))
    np.save(src, rng.uniform(-3, 3, (256, 3)).astype(np.float32))
    np.save(ref, rng.uniform(-3, 3, (256, 3)).astype(np.float32))
    assert infer_cli.main(["--checkpoint", str(best), "--source", str(src),
                           "--reference", str(ref), "--output", str(out),
                           "--num_steps", "2", "--device", "cpu"]) == 0
    result = np.load(out)
    assert result.shape == (256, 3) and np.isfinite(result).all()

    capsys.readouterr()
    assert compare_cli.main([str(out), str(ref), "--json",
                             "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_compare_cli.main([str(out), str(ref), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
    assert compare_cli.main([str(out), str(ref), "--device", "cpu"]) == 0
    assert "Chamfer distance" in capsys.readouterr().out
