"""The port's inference entry points on the CPU: checkpoint round trip, the
device rule, and ``cli.inference.main`` end to end with ``--device cpu``."""

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
