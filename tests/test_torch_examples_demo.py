"""``examples/demo_synthetic_torch.py`` on the CPU at a tiny size: 8
synthetic pairs of 12,600 points (the JAX demo's generator; the real side
has 12,000 fewer), preprocessed to 512 / 128 points at widths 32 / 16 in
float32, 2 epochs, 3 sampler steps: the transferred cloud and the
bidirectional test metrics exist and are finite."""

import os
import sys
from pathlib import Path

import torch_parity  # noqa: F401  (shares the cores among workers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import demo_synthetic_torch as demo  # noqa: E402


def test_demo_outputs_exist_and_are_finite(tmp_path):
    res = demo.main(["--workdir", str(tmp_path), "--points", "12600",
                     "--epochs", "2", "--steps", "3", "--device", "cpu",
                     "--config", "total_points=512", "global_points=128",
                     "feature_dim=32", "time_embed_dim=16", "use_amp=false"])
    assert res["finite"] and res["shape"] == (12600, 3)
    assert os.path.isdir(res["best_model"])
    for side in ("sim_to_real", "real_to_sim"):
        assert f"chamfer_{side}" in res["metrics"]
        assert f"emd_{side}" in res["metrics"]
    assert set(res["seconds"]) == {"data", "preprocess", "train", "transfer",
                                   "test"}
