"""The port's ``parallel/mesh.py`` and ``parallel/ring.py`` and their two
callers, on gloo process groups of 2 and 4 CPU ranks (``torch_dist``; one
group a world, every case of that world run inside it).

* ring minima (``rowmin`` a hop) bit for bit against the port's dense
  row minimum, a NaN ref included; ring kNN (``knn_topk`` a hop) distances
  bit for bit against the dense kNN, indices identical on rows whose k+1
  nearest are not tied; on {points: 2}, {points: 4} and the 2-D
  {data: 2, points: 2} mesh, where the ring's P2P peers are global ranks of
  a sub-group;
* ties across shards: on points with small integer coordinates (every
  distance exact in both packages' arithmetic, ties everywhere) the ring
  kNN's indices equal JAX's ``ring_knn`` on the same mesh shape (the
  earlier arrival wins);
* ``ring_min_sq_dist``, ``ring_chamfer_distance``, ``_l2`` and
  ``metrics.chamfer_distance(mesh=)`` against JAX's on the 8-device CPU
  mesh at JAX's bars (rtol 1e-5, atol 1e-6; its matmul-form distances
  round otherwise), the indivisible count's dense fallback included;
* ``make_mesh``: the default shape, a 2-D shape, a shape too large
  (``ValueError``), a mesh over the first ranks only; CUDA tensors on a
  gloo group raise;
* ``cli.test`` on 2 ranks (the ring Chamfer) against 1 rank: every metric
  within 1e-6 relative, files written by rank 0 only.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from pointcloud_style_transfer_torch.cli import test as port_test
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.data import PointCloudPreprocessor
from pointcloud_style_transfer_torch.evaluation import metrics
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_torch.ops.kernels import (knn_topk_plain,
                                                          rowmin_plain)
from pointcloud_style_transfer_torch.utils.checkpoint import (
    save_checkpoint, split_state_dict)
from pointcloud_style_transfer_tpu.evaluation import metrics as jax_metrics
from pointcloud_style_transfer_tpu.parallel import make_mesh as jax_mesh
from pointcloud_style_transfer_tpu.parallel import ring as jax_ring

RTOL, ATOL = 1e-5, 1e-6  # tests/test_sharding.py's bars
TESTER_RTOL = 1e-6
JAX_MESH = {"p2": {"points": 2}, "p4": {"points": 4},
            "d2p2": {"data": 2, "points": 2}}
CASES = [(world, tag) for world, meshes in torch_dist.RING_MESHES.items()
         for tag in meshes]
TESTER_CFG = dict(total_points=256, global_points=64, feature_dim=16,
                  time_embed_dim=8, use_amp=False, knn_backend="pallas")


def ring_inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    x = {"q": rng.standard_normal((2, 64, 3)).astype(f32) * 3,
         "r": rng.standard_normal((2, 128, 3)).astype(f32) * 3,
         "ql": rng.integers(-3, 4, (2, 64, 3)).astype(f32),
         "rl": rng.integers(-3, 4, (2, 128, 3)).astype(f32),
         "a": rng.standard_normal((2, 96, 3)).astype(f32),
         "b": rng.standard_normal((2, 160, 3)).astype(f32),
         "pred": rng.standard_normal((2, 128, 3)).astype(f32),
         "tgt": rng.standard_normal((2, 192, 3)).astype(f32)}
    x["r_nan"] = x["r"].copy()
    x["r_nan"][0, 100, 1] = np.nan  # in the last shard of every mesh
    return x


def cli_test_setup(tmp):
    """A checkpoint, a split of two pairs, the CLI's arguments."""
    torch.manual_seed(0)
    cfg = Config(**TESTER_CFG)
    net = PointCloudDiffusionModel(cfg, device="cpu").net
    ckpt = save_checkpoint(str(tmp / "model.pt"), cfg,
                           *split_state_dict(net))
    rng = np.random.default_rng(4)
    pre = PointCloudPreprocessor(total_points=256, global_points=64, seed=0)
    for i in range(2):
        pre.save_hierarchical_data(
            rng.uniform(-3, 3, (256, 3)).astype(np.float32),
            rng.uniform(-3, 3, (256, 3)).astype(np.float32),
            str(tmp / "split"), f"pair_{i}")
    return ["--checkpoint", ckpt, "--test_data", str(tmp / "split"),
            "--batch_size", "2", "--num_inference_steps", "2",
            "--compute_all_metrics", "--save_generated", "--device", "cpu",
            "--seed", "1"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both worlds' groups, run while the parent runs the 1-rank
    ``cli.test`` and JAX's ring."""
    x = ring_inputs()
    tmps, started = {}, []
    try:
        for world in torch_dist.RING_MESHES:
            tmp = tmps[world] = tmp_path_factory.mktemp(f"ring{world}")
            np.savez(tmp / "inputs.npz", **x)
            if world == 2:
                args = cli_test_setup(tmp)
                with open(tmp / "tester_args.json", "w") as f:
                    json.dump(args, f)
            started.append(torch_dist.start_group(torch_dist.ring_ranks,
                                                  world, tmp))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the ranks' arithmetic
        try:
            assert port_test.main(
                args + ["--output_dir", str(tmps[2] / "single")]) == 0
        finally:
            torch.set_num_threads(threads)
        jax = jax_values(x)
    finally:
        ranks = torch_dist.join_groups(*started)
    return {"x": x, "jax": jax,
            **{w: (tmps[w], r) for w, r in zip(tmps, ranks)}}


def per_rank(groups, world, tag, key):
    """(rank's result, its points coordinate) for every rank."""
    ranks = groups[world][1]
    return [(r[f"{tag}.{key}"], int(r[f"{tag}.coord"][0])) for r in ranks]


def rows(full, coord, world, tag):
    n = JAX_MESH[tag]["points"]
    size = full.shape[1] // n
    return full[:, coord * size:(coord + 1) * size]


@pytest.mark.parametrize("world,tag", CASES)
@pytest.mark.parametrize("key", ["min", "min_nan"])
def test_ring_min_bitwise(groups, world, tag, key):
    x = groups["x"]
    ref = x["r"] if key == "min" else x["r_nan"]
    dense = rowmin_plain(torch.from_numpy(x["q"]),
                         torch.from_numpy(ref)).numpy()
    if key == "min_nan":
        assert np.isnan(dense).any() and not np.isnan(dense).all()
    for got, c in per_rank(groups, world, tag, key):
        np.testing.assert_array_equal(got, rows(dense, c, world, tag))


@pytest.mark.parametrize("world,tag", CASES)
def test_ring_knn_matches_dense(groups, world, tag):
    x = groups["x"]
    d, i = knn_topk_plain(torch.from_numpy(x["q"]), torch.from_numpy(x["r"]),
                          4)
    d, i = d.numpy(), i.numpy()
    untied = (np.diff(d, axis=-1) > 0).all(-1)  # the 4 nearest distinct
    assert untied.mean() > 0.9
    for (gd, c), (gi, _) in zip(per_rank(groups, world, tag, "knn_d"),
                                per_rank(groups, world, tag, "knn_i")):
        np.testing.assert_array_equal(gd, rows(d[..., :3], c, world, tag))
        keep = rows(untied, c, world, tag)
        np.testing.assert_array_equal(gi[keep],
                                      rows(i[..., :3], c, world, tag)[keep])


def jax_values(x):
    """JAX's ring kNN on each mesh shape (its tie order depends on the
    ring), the values on {points: 4} (they do not)."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    mesh = jax_mesh({"points": 4})
    values = {
        "min": np.asarray(jax_ring.ring_min_sq_dist(j["q"], j["r"], mesh)),
        "chamfer": np.asarray(jax_ring.ring_chamfer_distance(j["a"], j["b"],
                                                             mesh)),
        "chamfer_l2": np.asarray(jax_ring.ring_chamfer_distance_l2(
            j["a"], j["b"], mesh)),
        "metric": np.asarray(jax_metrics.chamfer_distance(
            j["pred"], j["tgt"], mesh=mesh)),
        "metric_odd": np.asarray(jax_metrics.chamfer_distance(
            j["pred"][:, :-1], j["tgt"], mesh=mesh))}
    out = {}
    for tag, shape in JAX_MESH.items():
        d, i = jax_ring.ring_knn(j["ql"], j["rl"], 3, jax_mesh(shape))
        out[tag] = {**values, "lattice_d": np.asarray(d),
                    "lattice_i": np.asarray(i)}
    return out


@pytest.fixture(scope="module")
def jax_side(groups):
    return groups["jax"]


@pytest.mark.parametrize("world,tag", CASES)
def test_ring_knn_ties_match_jax(groups, jax_side, world, tag):
    want = jax_side[tag]
    ties = 0
    for (gd, c), (gi, _) in zip(per_rank(groups, world, tag, "lattice_d"),
                                per_rank(groups, world, tag, "lattice_i")):
        np.testing.assert_array_equal(gd, rows(want["lattice_d"], c, world,
                                               tag))
        np.testing.assert_array_equal(gi, rows(want["lattice_i"], c, world,
                                               tag))
        ties += int((np.diff(gd, axis=-1) == 0).sum())
    assert ties > 100  # the lattice plants ties everywhere


@pytest.mark.parametrize("world,tag", CASES)
def test_ring_min_matches_jax(groups, jax_side, world, tag):
    for got, c in per_rank(groups, world, tag, "min"):
        np.testing.assert_allclose(got, rows(jax_side[tag]["min"], c, world,
                                             tag), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world,tag", CASES)
@pytest.mark.parametrize("key", ["chamfer", "chamfer_l2", "metric",
                                 "metric_odd"])
def test_ring_chamfer_matches_jax(groups, jax_side, world, tag, key):
    """Every rank returns the same [B], JAX's within its bars; the metric
    also the port's dense Chamfer."""
    x = groups["x"]
    got = [r[f"{tag}.{key}"] for r in groups[world][1]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], jax_side[tag][key], rtol=RTOL,
                               atol=ATOL)
    if key.startswith("metric"):
        pred = x["pred"] if key == "metric" else x["pred"][:, :-1]
        dense = metrics.chamfer_distance(torch.from_numpy(pred),
                                         torch.from_numpy(x["tgt"])).numpy()
        np.testing.assert_allclose(got[0], dense, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key,want", [
    ("mesh.default", [1, 4]), ("mesh.two_d", [2, 2, 2]),
    ("mesh.too_big_raises", [1]), ("mesh.backend_mismatch_raises", [1])])
def test_make_mesh(groups, key, want):
    for r in groups[4][1]:
        assert r[key].tolist() == want


def test_mesh_placements(groups):
    """The ``DTensor`` placements that stand for JAX's shardings."""
    for r in groups[4][1]:
        assert r["mesh.placements"].tolist() == [
            "[Replicate(), Replicate()]", "[Shard(dim=0), Replicate()]",
            "[Shard(dim=0), Shard(dim=1)]"]


def test_make_mesh_first_ranks(groups):
    """{data: 2} in a world of 4 holds ranks 0 and 1; the others raise."""
    assert [int(r["mesh.subset_rank"][0]) for r in groups[4][1]] == \
        [0, 1, -1, -1]


def test_tester_ring_matches_one_rank(groups):
    tmp, ranks = groups[2]
    assert [int(r["tester.rc"][0]) for r in ranks] == [0, 0]

    def results(directory):
        (run,) = os.listdir(directory)
        with open(os.path.join(directory, run, "test_results.json")) as f:
            return json.load(f)["average_metrics"]
    want = results(tmp / "single")
    got = results(tmp / "tester_rank0")
    assert list(got) == list(port_test.METRIC_KEYS) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TESTER_RTOL,
                                   err_msg=k)


def test_tester_writes_on_rank0_only(groups):
    tmp, _ = groups[2]
    files = [json.loads((tmp / f"tester_files{r}.json").read_text())
             for r in range(2)]
    assert files[1] == []
    names = {os.path.basename(f) for f in files[0]}
    assert {"test_config.json", "test_results.json",
            "sim_to_real_0000.npy"} <= names
