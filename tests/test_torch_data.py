"""The port's data pipeline against the JAX package's: both are numpy, so
the same seeds must give identical arrays, identical files and identical
batches in the same order (no tolerance anywhere)."""

import json

import numpy as np
import pytest

from pointcloud_style_transfer_torch.cli import preprocess as port_pre_cli
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import dataset as port_ds
from pointcloud_style_transfer_torch.data import preprocessing as port_pre
from pointcloud_style_transfer_torch.data import synthetic as port_syn
from pointcloud_style_transfer_tpu.cli import preprocess as jax_pre_cli
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.data import dataset as jax_ds
from pointcloud_style_transfer_tpu.data import preprocessing as jax_pre
from pointcloud_style_transfer_tpu.data import synthetic as jax_syn


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed,n", [(0, 3000), (7, 5000)])
def test_synthetic_pairs_identical(seed, n):
    got = port_syn.lidar_scene_pair(np.random.default_rng(seed), n)
    want = jax_syn.lidar_scene_pair(np.random.default_rng(seed), n)
    assert_trees_equal(got, want)
    assert got[0].dtype == np.float32 and got[0].shape == (n, 3)


def test_preprocessing_functions_identical(rng):
    pts = rng.uniform(-4, 4, (2000, 3)).astype(np.float32)
    assert_trees_equal(port_pre.normalize_point_cloud(pts),
                       jax_pre.normalize_point_cloud(pts))
    got = port_pre.voxel_grid_downsample(pts, 500, np.random.default_rng(1))
    want = jax_pre.voxel_grid_downsample(pts, 500, np.random.default_rng(1))
    assert_trees_equal(got, want)
    coarse, idx = got
    assert_trees_equal(port_pre.consistent_upsample(coarse, pts, idx),
                       jax_pre.consistent_upsample(coarse, pts, idx))


@pytest.mark.parametrize("n_in", [1500, 1000, 700])  # down, equal, up
def test_preprocessor_identical(tmp_path, rng, n_in):
    sim = rng.uniform(-3, 3, (n_in, 3)).astype(np.float32)
    real = rng.uniform(-3, 3, (n_in, 3)).astype(np.float32)
    paths = []
    for pkg, name in ((port_pre, "port"), (jax_pre, "jax")):
        pre = pkg.PointCloudPreprocessor(total_points=1000, global_points=250,
                                         seed=3)
        assert_trees_equal(pre.create_hierarchical_data(sim),
                           pkg.PointCloudPreprocessor(
                               1000, 250, seed=3).create_hierarchical_data(
                                   sim))
        paths.append(pre.save_hierarchical_data(sim, real,
                                                str(tmp_path / name), "p0"))
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_split_indices_identical():
    for n in (1, 4, 5, 10, 37):
        assert port_pre_cli.split_indices(n) == jax_pre_cli.split_indices(n)


def write_processed(tmp_path, n_train=5, n_val=2, total=200, gpts=50):
    rng = np.random.default_rng(0)
    pre = port_pre.PointCloudPreprocessor(total, gpts, seed=0)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            pre.save_hierarchical_data(
                rng.uniform(-3, 3, (total, 3)).astype(np.float32),
                rng.uniform(-3, 3, (total, 3)).astype(np.float32),
                str(tmp_path / split), f"{split}_{i:04d}")
    return tmp_path


@pytest.mark.parametrize("batch_size,shuffle,drop_last,workers", [
    (2, True, True, 0), (2, True, False, 0), (3, False, False, 0),
    (2, True, True, 2)])
def test_batcher_order_identical(tmp_path, batch_size, shuffle, drop_last,
                                 workers):
    d = str(write_processed(tmp_path) / "train")
    port = port_ds.Batcher(port_ds.HierarchicalPointCloudDataset(d),
                           batch_size, shuffle, drop_last, seed=5,
                           num_workers=workers)
    jax_b = jax_ds.Batcher(jax_ds.HierarchicalPointCloudDataset(d),
                           batch_size, shuffle, drop_last, seed=5,
                           num_workers=workers)
    assert len(port) == len(jax_b)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_b.set_epoch(epoch)
        got, want = list(port), list(jax_b)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert_trees_equal(g, w)


def test_create_dataloaders_identical(tmp_path):
    root = str(write_processed(tmp_path))
    kw = dict(processed_data_dir=root, batch_size=2, num_workers=0)
    got = port_ds.create_dataloaders(Config(**kw))
    want = jax_ds.create_dataloaders(JaxConfig(**kw))
    for g, w in zip(got, want):
        assert_trees_equal(list(g), list(w))


def test_corrupt_file_raises(tmp_path):
    d = tmp_path / "train"
    d.mkdir()
    (d / "bad_hierarchical.npz").write_bytes(b"not a zip")
    ds = port_ds.HierarchicalPointCloudDataset(str(d))
    with pytest.raises(RuntimeError):
        ds[0]
    assert port_ds.HierarchicalPointCloudDataset(
        str(d), on_error="zeros")[0]["sim_full"].shape == (120000, 3)
    with pytest.raises(FileNotFoundError):
        port_ds.HierarchicalPointCloudDataset(str(tmp_path / "missing"))


def test_preprocess_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for side in ("sim", "real"):
        (tmp_path / side).mkdir()
        for i in range(5):
            np.save(tmp_path / side / f"c{i}.npy",
                    rng.uniform(-5, 5, (300, 3)).astype(np.float32))
    args = ["--sim_dir", str(tmp_path / "sim"), "--real_dir",
            str(tmp_path / "real"), "--total_points", "200",
            "--global_points", "50"]
    assert port_pre_cli.main(args + ["--output_dir", str(tmp_path / "p"),
                                     "--device", "cpu"]) == 0
    assert jax_pre_cli.main(args + ["--output_dir", str(tmp_path / "j")]) == 0
    assert json.loads((tmp_path / "p/preprocessing_config.json").read_text()) \
        == json.loads((tmp_path / "j/preprocessing_config.json").read_text())
    files = sorted(p.relative_to(tmp_path / "p")
                   for p in (tmp_path / "p").rglob("*.npz"))
    assert len(files) == 5
    for f in files:
        with np.load(tmp_path / "p" / f) as a, np.load(tmp_path / "j" / f) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")
