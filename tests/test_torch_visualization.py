"""``utils.visualization`` (the port's own copy) against the JAX package's:
the plot subsample takes the same indices, the PLY writer the same bytes,
the plot writes a PNG under Agg, the open3d viewer degrades to False
without open3d; and ``cli.visualize`` and ``cli.inference --visualize``."""

import builtins

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.utils import visualization as port_vis
from pointcloud_style_transfer_tpu.utils import visualization as jax_vis

pytest.importorskip("matplotlib")


@pytest.mark.parametrize("n, k, seed", [(500, 100, 0), (500, 100, 7),
                                        (50, 100, 0), (8000, 7999, 3)])
def test_subsample_same_indices(rng, n, k, seed):
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_vis._subsample(pts, k, seed),
                                  jax_vis._subsample(pts, k, seed))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_as_ply_same_bytes(rng, tmp_path, dtype):
    pts = (rng.standard_normal((123, 3)) * 10).astype(dtype)
    pts[0] = [0.0, -0.0, 1e-7]
    port_vis.save_as_ply(pts, str(tmp_path / "a" / "port.ply"))
    jax_vis.save_as_ply(pts, str(tmp_path / "b" / "jax.ply"))
    got = (tmp_path / "a" / "port.ply").read_bytes()
    assert got == (tmp_path / "b" / "jax.ply").read_bytes()
    assert got.startswith(b"ply\nformat ascii 1.0\nelement vertex 123\n")


def test_plot_writes_png(rng, tmp_path):
    clouds = [rng.standard_normal((300, 3)).astype(np.float32)
              for _ in range(3)]
    path = tmp_path / "sub" / "plot.png"
    assert port_vis.plot_style_transfer_result(*clouds, title="t",
                                               save_path=str(path),
                                               sample_size=100)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    import matplotlib
    assert matplotlib.get_backend().lower() == "agg"
    path2 = tmp_path / "facade.png"
    assert port_vis.PointCloudVisualizer.visualize_comparison(
        *clouds, save_path=str(path2))
    assert path2.stat().st_size > 0


def test_interactive_without_open3d(monkeypatch, capsys):
    real_import = builtins.__import__

    def no_open3d(name, *args, **kwargs):
        if name == "open3d":
            raise ImportError("no open3d")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_open3d)
    assert port_vis.visualize_interactive([np.zeros((2, 3))], ["a"]) is False
    assert "open3d not available" in capsys.readouterr().out


def test_visualize_cli(rng, tmp_path):
    from pointcloud_style_transfer_torch.cli import visualize as vis_cli
    for name in ("o", "g", "r"):
        np.save(tmp_path / f"{name}.npy",
                rng.standard_normal((200, 3)).astype(np.float32))
    png, ply = tmp_path / "out.png", tmp_path / "out.ply"
    rc = vis_cli.main(["--original", str(tmp_path / "o.npy"),
                       "--generated", str(tmp_path / "g.npy"),
                       "--reference", str(tmp_path / "r.npy"),
                       "--output", str(png), "--export_ply", str(ply),
                       "--sample_size", "100"])
    assert rc == 0 and png.stat().st_size > 0
    jax_ply = tmp_path / "jax.ply"
    jax_vis.save_as_ply(np.load(tmp_path / "g.npy"), str(jax_ply))
    assert ply.read_bytes() == jax_ply.read_bytes()


def test_inference_cli_visualize(rng, tmp_path):
    """``--visualize`` writes the 3-panel plot beside the output."""
    from pointcloud_style_transfer_torch.cli import inference as infer_cli
    from pointcloud_style_transfer_torch.config import Config
    from pointcloud_style_transfer_torch.models import DiffusionNet
    from pointcloud_style_transfer_torch.utils.checkpoint import (
        save_checkpoint, split_state_dict)
    cfg = Config(total_points=256, global_points=64, feature_dim=16,
                 time_embed_dim=8, use_amp=False)
    torch.manual_seed(0)
    ckpt = save_checkpoint(str(tmp_path / "m.pt"), cfg, *split_state_dict(
        DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)))
    for name in ("s", "r"):
        np.save(tmp_path / f"{name}.npy",
                rng.standard_normal((256, 3)).astype(np.float32))
    out = tmp_path / "o" / "out.npy"
    rc = infer_cli.main(["--checkpoint", ckpt, "--source",
                         str(tmp_path / "s.npy"), "--reference",
                         str(tmp_path / "r.npy"), "--output", str(out),
                         "--num_steps", "2", "--visualize", "--device",
                         "cpu"])
    assert rc == 0 and np.load(out).shape == (256, 3)
    assert (tmp_path / "o" / "out.png").stat().st_size > 0
