"""The port's inference entry points on the CPU: checkpoint round trip, the
device rule, and ``cli.inference.main`` end to end with ``--device cpu``:
one pair, ``--fast``, and ``--source_dir`` batches with a ragged tail."""

import os

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.cli import inference
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import (denormalize_point_cloud,
                                                  normalize_point_cloud)
from pointcloud_style_transfer_torch.device import resolve_device
from pointcloud_style_transfer_torch.models import DiffusionNet
from pointcloud_style_transfer_torch.utils.checkpoint import (
    load_checkpoint, load_for_inference, save_checkpoint, split_state_dict)
from pointcloud_style_transfer_tpu.data import \
    normalize_point_cloud as jax_normalize

SMALL = dict(total_points=600, global_points=256, feature_dim=32,
             time_embed_dim=16)


@pytest.fixture
def checkpoint(tmp_path):
    cfg = Config(**SMALL)
    torch.manual_seed(0)
    net = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    params, stats = split_state_dict(net)
    ema = {k: v * 0.9 for k, v in params.items()}
    return save_checkpoint(str(tmp_path / "ck" / "model.pt"), cfg, params,
                           stats, ema_params=ema), params, ema


def test_checkpoint_round_trip_prefers_ema(checkpoint):
    path, params, ema = checkpoint
    ck = load_checkpoint(path)
    assert Config.from_dict(ck["config"]) == Config(**SMALL)
    config, model = load_for_inference(path, device="cpu")
    assert config == Config(**SMALL) and model.device.type == "cpu"
    for k, v in model.net.named_parameters():
        assert torch.equal(v, ema[k])


def test_device_rule(checkpoint):
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            inference.DiffusionInference(checkpoint[0])


def test_normalize_matches_jax(rng):
    pts = (rng.standard_normal((500, 3)) * 20 + 5).astype(np.float32)
    ours, p = normalize_point_cloud(pts)
    ref, rp = jax_normalize(pts)
    np.testing.assert_array_equal(ours, ref)
    assert p["scale"] == rp["scale"]
    np.testing.assert_allclose(denormalize_point_cloud(ours, p), pts,
                               rtol=1e-5, atol=1e-4)


def test_inference_main_cpu(checkpoint, tmp_path, rng):
    path = checkpoint[0]
    src = (rng.standard_normal((600, 3)) * 10).astype(np.float32)
    ref = (rng.standard_normal((700, 3)) * 10).astype(np.float32)
    np.save(tmp_path / "src.npy", src)
    np.savetxt(tmp_path / "ref.txt", ref, delimiter=",")
    out = tmp_path / "out" / "res.npy"
    rc = inference.main(["--checkpoint", path, "--source",
                         str(tmp_path / "src.npy"), "--reference",
                         str(tmp_path / "ref.txt"), "--output", str(out),
                         "--num_steps", "4", "--device", "cpu"])
    assert rc == 0 and os.path.exists(out)
    res = np.load(out)
    assert res.shape == (600, 3) and res.dtype == np.float32
    assert np.isfinite(res).all()
    # the same seed through the engine gives the same cloud
    engine = inference.DiffusionInference(path, seed=0, device="cpu")
    again = engine.transfer_style_hierarchical(src, ref, num_steps=4)
    np.testing.assert_array_equal(again, res)
    # a failing run reports a non-zero status instead of raising
    assert inference.main(["--checkpoint", str(tmp_path / "missing.pt"),
                           "--source", "a.npy", "--reference", "b.npy",
                           "--output", "c.npy", "--device", "cpu"]) == 1


def test_inference_main_fast_cpu(checkpoint, tmp_path, rng):
    """``--fast``: the coarse displacement sampler; the same seed through
    the engine gives the same cloud, another cloud than the per-step mode."""
    path = checkpoint[0]
    src = (rng.standard_normal((600, 3)) * 10).astype(np.float32)
    ref = (rng.standard_normal((700, 3)) * 10).astype(np.float32)
    np.save(tmp_path / "src.npy", src)
    np.save(tmp_path / "ref.npy", ref)
    out = tmp_path / "fast.npy"
    rc = inference.main(["--checkpoint", path, "--source",
                         str(tmp_path / "src.npy"), "--reference",
                         str(tmp_path / "ref.npy"), "--output", str(out),
                         "--num_steps", "4", "--fast", "--device", "cpu"])
    assert rc == 0
    res = np.load(out)
    assert res.shape == (600, 3) and res.dtype == np.float32
    assert np.isfinite(res).all()
    engine = inference.DiffusionInference(path, seed=0, device="cpu",
                                          fast=True)
    assert engine.fast
    again = engine.transfer_style_hierarchical(src, ref, num_steps=4)
    np.testing.assert_array_equal(again, res)
    slow = inference.DiffusionInference(path, seed=0, device="cpu")
    assert not np.array_equal(
        slow.transfer_style_hierarchical(src, ref, num_steps=4), res)


@pytest.mark.parametrize("by_name", [False, True])
def test_inference_main_source_dir_cpu(checkpoint, tmp_path, rng, monkeypatch,
                                       by_name):
    """Three clouds of other sizes at ``--batch_size 2``: two batches, the
    second padded with its last pair; one output per source, resampled to
    the checkpoint's ``total_points``."""
    path = checkpoint[0]
    (tmp_path / "srcs").mkdir()
    (tmp_path / "refs").mkdir()
    for name, n in (("b", 600), ("a", 450), ("c", 900)):
        np.save(tmp_path / "srcs" / f"{name}.npy",
                (rng.standard_normal((n, 3)) * 10).astype(np.float32))
        np.save(tmp_path / "refs" / f"{name}.npy",
                (rng.standard_normal((n + 50, 3)) * 10).astype(np.float32))
    out_dir = tmp_path / "outs"
    ref_args = (["--reference_dir", str(tmp_path / "refs")] if by_name else
                ["--reference", str(tmp_path / "refs" / "a.npy")])
    calls = []
    sampler = inference.guided_sample_loop

    def spy(model, schedule, src, ref, **kw):
        calls.append((tuple(src.shape), tuple(ref.shape)))
        return sampler(model, schedule, src, ref, **kw)
    monkeypatch.setattr(inference, "guided_sample_loop", spy)
    rc = inference.main(["--checkpoint", path, "--source_dir",
                         str(tmp_path / "srcs"), *ref_args, "--output_dir",
                         str(out_dir), "--batch_size", "2", "--num_steps", "2",
                         "--device", "cpu"])
    assert rc == 0
    assert calls == [((2, 600, 3), (2, 600, 3))] * 2
    assert sorted(os.listdir(out_dir)) == [
        f"{n}_transferred.npy" for n in "abc"]
    for n in "abc":
        res = np.load(out_dir / f"{n}_transferred.npy")
        assert res.shape == (600, 3) and res.dtype == np.float32
        assert np.isfinite(res).all()


def test_inference_main_argument_rules(checkpoint, tmp_path):
    path = checkpoint[0]
    for argv in (["--checkpoint", path, "--source", "a.npy"],
                 ["--checkpoint", path, "--source_dir", str(tmp_path)]):
        with pytest.raises(SystemExit):
            inference.main(argv + ["--device", "cpu"])
    # an empty source directory is a failing run, not an exception
    assert inference.main(["--checkpoint", path, "--source_dir",
                           str(tmp_path), "--reference", "r.npy",
                           "--device", "cpu"]) == 1
