"""``cli.test``: the port's ``Tester`` against the JAX package's on two
pairs at batch 2, both directions, every metric, and the CLI end to end.

Both testers get the same (perturbed) weights: the JAX one is built around
the Flax variables with its ``__init__`` bypassed (one device, the dense
Chamfer), the port's loads them from a ``.pt`` checkpoint through
``convert.flax_to_torch``. Both get the same draws: the JAX ``Tester``
splits its key once per sampler call and once per EMD call; the initial
noise and the voxel priorities of each sampler call are recomputed from
those keys (``torch_parity.sampler_draws``) and passed to the port's
``Tester.test``. The FPS starts are pinned to 0; the clouds (600 points)
are below the EMD's subsample size, so its keys draw nothing. The JAX side
runs its brute kNN and row-min kernels in interpret mode, the port its
plain kernels in XLA's CPU FMA form, so both pick the same neighbours.

Float32, hierarchical branch (600 points, 256 coarse), 2 steps. Every
discrete choice agrees (voxel orders, neighbours), but the first DDIM step
(t = 999) divides the predicted noise by sqrt(alpha_bar) and amplifies the
denoiser's float32 rounding (~4e-6) at a few outlying points to ~7e-3: the
JAX package's own eager and jitted runs of this sampler differ by 2.2e-3 at
the same points (measured). So the generated clouds agree within 1e-5 at
all but ``MAX_LOOSE`` points a cloud and within ``LOOSE_ATOL`` everywhere
(measured: 2 points, 7.3e-3), and each metric within ``RTOL`` (measured: at
most 1.9e-4 relative in a batch, 7.8e-5 in the averages).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.cli import test as port_test
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.convert import flax_to_torch
from pointcloud_style_transfer_torch.data import Batcher as PortBatcher
from pointcloud_style_transfer_torch.data import \
    HierarchicalPointCloudDataset as PortDataset
from pointcloud_style_transfer_torch.models import PointCloudDiffusionModel
from pointcloud_style_transfer_torch.utils.checkpoint import (
    save_checkpoint, split_state_dict)
from pointcloud_style_transfer_tpu.cli import test as jax_test
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.data import Batcher as JaxBatcher
from pointcloud_style_transfer_tpu.data import \
    HierarchicalPointCloudDataset as JaxDataset
from pointcloud_style_transfer_tpu.evaluation import metrics as jax_metrics
from pointcloud_style_transfer_tpu.models import \
    PointCloudDiffusionModel as JaxModel
from pointcloud_style_transfer_tpu.models import guided_sample_loop
from pointcloud_style_transfer_tpu.models import make_schedule
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk
from pointcloud_style_transfer_tpu.utils.logger import get_logger

from torch_parity import (pallas_vjp_min_sq_dist, perturbed, pin_jax_encoder,
                          sampler_draws, xla_cpu_distances)

SMALL = dict(total_points=600, global_points=256, feature_dim=32,
             time_embed_dim=16, use_amp=False, knn_backend="pallas")
N, M, B, PAIRS, STEPS, SEED = 600, 256, 2, 4, 2, 0
RTOL = 1e-3  # per metric, relative; measured at most 7.8e-5
MAX_LOOSE, LOOSE_ATOL = 6, 2e-2  # points a cloud past 1e-5; measured 2, 7.3e-3


def write_split(directory, rng, pairs=PAIRS, n=N, m=M):
    """``pairs`` hierarchical ``.npz`` files in the format cli.preprocess
    writes (normalised clouds, a global subset and its indices)."""
    os.makedirs(directory, exist_ok=True)
    for i in range(pairs):
        sim = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
        real = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
        idx = np.arange(m, dtype=np.int32)
        np.savez(os.path.join(directory, f"pair_{i:03d}_hierarchical.npz"),
                 sim_full=sim, real_full=real, sim_global=sim[:m],
                 real_global=real[:m], sim_global_indices=idx,
                 real_global_indices=idx, sim_norm_center=np.zeros(3),
                 sim_norm_scale=1.0, real_norm_center=np.zeros(3),
                 real_norm_scale=1.0, total_points=n, global_points=m)
    return directory


def jax_tester_draws(seed, batches):
    """Per batch, the port's draws for the keys the JAX ``Tester`` splits:
    two sampler calls, then one EMD call per direction."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(batches):
        d = {}
        for tag in ("sim_to_real", "real_to_sim"):
            key, k = jax.random.split(key)
            cond_u, step_u = sampler_draws(k, STEPS, N, N, M, batch=B)
            k_init = jax.random.split(k, 4)[2]
            d[tag] = dict(
                x_init=torch.from_numpy(np.array(
                    jax.random.normal(k_init, (B, N, 3), jnp.float32))),
                cond_priority=torch.from_numpy(cond_u),
                step_priorities=torch.from_numpy(step_u),
                fps_starts=torch.zeros((2, B), dtype=torch.int64))
        for tag in ("sim_to_real", "real_to_sim"):
            key, _ = jax.random.split(key)  # the EMD's: N <= its subsample
            d[f"emd_{tag}"] = (None, None)
        out.append(d)
    return out


def jax_knn_interpret(query, ref, k, chunk_size=2048, backend=None):
    return distance_topk.pallas_knn(query, ref, k, interpret=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights, a checkpoint, a test split of 4 pairs and the JAX result."""
    tmp = tmp_path_factory.mktemp("cli_test")
    rng = np.random.default_rng(5)
    split = write_split(str(tmp / "test"), rng)
    jcfg = JaxConfig(**SMALL)
    jmodel = JaxModel(jcfg)
    v = jmodel.init(jax.random.PRNGKey(0), example_points=256)
    variables = {"params": perturbed(v["params"], rng),
                 "batch_stats": perturbed(v["batch_stats"], rng)}
    tmodel = PointCloudDiffusionModel(Config(**SMALL), device="cpu")
    tmodel.net.load_state_dict(flax_to_torch(variables))
    ckpt = save_checkpoint(str(tmp / "model.pt"), Config(**SMALL),
                           *split_state_dict(tmodel.net))

    jt = jax_test.Tester.__new__(jax_test.Tester)
    jt.logger = get_logger("Tester")
    jt.output_dir = str(tmp / "jax_out")
    os.makedirs(jt.output_dir)
    jt.config, jt.model, jt.variables = jcfg, jmodel, variables
    jt.schedule = make_schedule(jcfg)
    jt._key = jax.random.PRNGKey(SEED)
    jt._sampler = guided_sample_loop
    jt.mesh = None  # one device: the dense Chamfer
    mp = pytest.MonkeyPatch()
    try:
        pin_jax_encoder(mp)
        pallas_vjp_min_sq_dist(mp)
        mp.setattr(distance_topk, "pallas_knn", functools.partial(
            distance_topk.pallas_knn, interpret=True))
        mp.setattr(jax_metrics, "knn", jax_knn_interpret)
        loader = JaxBatcher(JaxDataset(split), batch_size=B, shuffle=False,
                            drop_last=False)
        want = jt.test(loader, num_inference_steps=STEPS,
                       compute_all_metrics=True, save_generated=True)
    finally:
        mp.undo()
    return dict(tmp=tmp, split=split, ckpt=ckpt, want=want,
                jax_gen=os.path.join(jt.output_dir, "generated"))


def test_tester_matches_jax(setup):
    out_dir = str(setup["tmp"] / "port_out")
    tester = port_test.Tester(setup["ckpt"], out_dir, seed=SEED,
                              device="cpu")
    loader = PortBatcher(PortDataset(setup["split"]), batch_size=B,
                         shuffle=False, drop_last=False)
    with xla_cpu_distances():
        got = tester.test(loader, num_inference_steps=STEPS,
                          compute_all_metrics=True, save_generated=True,
                          draws=jax_tester_draws(SEED, PAIRS // B))
    got, want = got["average_metrics"], setup["want"]["average_metrics"]
    assert list(got) == list(want) == list(port_test.METRIC_KEYS)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    files = sorted(os.listdir(os.path.join(out_dir, "generated")))
    assert files == sorted(os.listdir(setup["jax_gen"]))
    assert len(files) == 4 * PAIRS and "sim_to_real_0003.npy" in files
    for name in files:
        a = np.load(os.path.join(out_dir, "generated", name))
        b = np.load(os.path.join(setup["jax_gen"], name))
        err = np.abs(a - b).max(axis=-1)
        assert (err > 1e-5).sum() <= MAX_LOOSE and err.max() <= LOOSE_ATOL, \
            (name, (err > 1e-5).sum(), err.max())
    assert tester.emd_perms == [{"sim_to_real": (None, None),
                                 "real_to_sim": (None, None)}] * 2


def test_emd_permutations_drawn_past_subsample(monkeypatch):
    """Clouds above the EMD's subsample size: each call draws one
    permutation per cloud from the tester's generator, keeps it, and the
    EMD is the Sinkhorn of the subsampled clouds."""
    monkeypatch.setattr(port_test, "EMD_MAX_POINTS", 100)
    tester = port_test.Tester.__new__(port_test.Tester)
    tester.device = torch.device("cpu")
    tester.generator = torch.Generator().manual_seed(3)
    a, b = tester._emd_perm(150), tester._emd_perm(150)
    assert sorted(a.tolist()) == list(range(150))
    assert not torch.equal(a, b)
    assert tester._emd_perm(100) is None


def test_cli_main_end_to_end(setup):
    out = setup["tmp"] / "cli"
    rc = port_test.main([
        "--checkpoint", setup["ckpt"], "--test_data", setup["split"],
        "--output_dir", str(out), "--batch_size", "2",
        "--num_inference_steps", "2", "--num_samples", "2",
        "--compute_all_metrics", "--save_generated",
        "--save_visualizations", "--device", "cpu", "--seed", "1"])
    assert rc == 0
    (run,) = os.listdir(out)
    run = out / run
    with open(run / "test_results.json") as f:
        results = json.load(f)["average_metrics"]
    assert list(results) == list(port_test.METRIC_KEYS)
    assert all(np.isfinite(v) for v in results.values())
    with open(run / "test_config.json") as f:
        cfg = json.load(f)
    assert cfg["device"] == "cpu" and cfg["seed"] == 1
    assert len(os.listdir(run / "generated")) == 8
    assert sorted(os.listdir(run / "visualizations")) == [
        "sample_0000_s2r.png", "sample_0001_s2r.png"]


def test_cli_without_card_raises(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.main(["--checkpoint", setup["ckpt"], "--test_data",
                        setup["split"], "--output_dir", str(tmp_path)])


def test_chip_smoke_cpu_reference(setup, tmp_path):
    """``chip_smoke.py``'s CPU recomputation of cli.test's metrics (float64
    nearest neighbours and Sinkhorn from the saved clouds) agrees with the
    port's ``Tester`` on the CPU within the bars the card is held to, and
    its float64 Sinkhorn with the port's float32 one."""
    import chip_smoke
    from pointcloud_style_transfer_torch.evaluation import metrics
    tester = port_test.Tester(setup["ckpt"], str(tmp_path), seed=2,
                              device="cpu")
    loader = PortBatcher(PortDataset(setup["split"]), batch_size=B,
                         shuffle=False, drop_last=False)
    got = tester.test([next(iter(loader))], num_inference_steps=STEPS,
                      save_generated=True)["average_metrics"]
    want = chip_smoke.cpu_test_metrics(str(tmp_path / "generated"), B,
                                       tester.emd_perms[0])
    assert list(want) == list(got)
    for k, v in got.items():
        if k.startswith("coverage"):
            assert abs(v - want[k]) <= chip_smoke.COVERAGE_ATOL, k
        else:
            rtol = chip_smoke.TEST_RTOL[k.split("_")[0]]
            assert abs(v - want[k]) <= rtol * abs(want[k]), (k, v, want[k])
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((300, 3)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((200, 3)) * 0.5).astype(np.float32)
    ref = metrics._sinkhorn_emd(torch.from_numpy(a)[None],
                                torch.from_numpy(b)[None]).item()
    np.testing.assert_allclose(chip_smoke.sinkhorn_emd_f64(a, b), ref,
                               rtol=1e-4)
