"""The port's tooling: ``cli.progress`` over a 2-epoch checkpoint
directory, ``cli.benchmark --quick`` (the JAX ``main``'s JSON keys, less its
``note``), ``PointCloudMetrics``, ``Logger``, ``load_checkpoint_config``,
``utils.profiling``, and the device rule: a CLI that computes on a device
raises when asked for the card (its default) on a machine without one."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.cli import benchmark as bench_cli
from pointcloud_style_transfer_torch.cli import progress as progress_cli
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.evaluation import (PointCloudMetrics,
                                                        chamfer_distance,
                                                        metrics)
from pointcloud_style_transfer_torch.models import DiffusionNet
from pointcloud_style_transfer_torch.utils import (CheckpointManager, Logger,
                                                   load_checkpoint_config,
                                                   profiling, save_checkpoint,
                                                   split_state_dict)

TINY = dict(total_points=128, global_points=32, feature_dim=16,
            time_embed_dim=8, use_amp=False)

# The JSON keys of the JAX package's cli/benchmark.py ``main`` (``results``
# and the dicts its bench_* functions return), read from its code; the
# port leaves out ``note``, a remark about tunneled TPU backends.
JAX_KEYS = {"device", "quick", "note", "forward", "hierarchical_vs_direct",
            "scaling", "sampling", "sampling_batched"}
FORWARD_KEYS = {"batch", "points", "latency_ms", "throughput_pts_per_s",
                "memory_mb"}
HIER_KEYS = {"points", "hierarchical_ms", "direct_ms", "speedup",
             "hierarchical_memory_mb", "direct_memory_mb"}
SAMPLING_KEYS = {"points", "steps", "batch", "seconds_per_batch",
                 "seconds_per_cloud", "points_per_sec_per_chip", "memory_mb"}


def experiment(tmp_path, epochs=2):
    """A port training checkpoint directory with ``epochs`` epochs."""
    cfg = Config(**TINY)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "prog")
    for ep in range(epochs):
        torch.manual_seed(ep)
        params, stats = split_state_dict(DiffusionNet(cfg.feature_dim,
                                                      cfg.time_embed_dim))
        mgr.save({"params": params, "batch_stats": stats,
                  "ema_params": params}, ep, cfg, is_best=ep == 0)
    return mgr, cfg


def clouds(tmp_path, rng, n=128):
    paths = []
    for name in ("s", "r"):
        paths.append(str(tmp_path / f"{name}.npy"))
        np.save(paths[-1], rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    return paths


def test_progress_cli(tmp_path, rng):
    pytest.importorskip("matplotlib")
    mgr, _ = experiment(tmp_path)
    assert mgr.list_epochs() == [0, 1]
    src, ref = clouds(tmp_path, rng)
    out = tmp_path / "prog.png"
    rc = progress_cli.main(["--checkpoint_dir", mgr.base_dir, "--source",
                            src, "--reference", ref, "--output", str(out),
                            "--num_steps", "2", "--device", "cpu"])
    assert rc == 0 and out.read_bytes()[:4] == b"\x89PNG"


def test_progress_cli_empty_dir(tmp_path, rng):
    src, ref = clouds(tmp_path, rng)
    rc = progress_cli.main(["--checkpoint_dir", str(tmp_path / "none"),
                            "--source", src, "--reference", ref,
                            "--device", "cpu"])
    assert rc == 1


def test_benchmark_cli_quick(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc = bench_cli.main(["--quick", "--device", "cpu", "--reps", "1",
                         "--output", str(out)])
    assert rc == 0
    with open(out) as f:
        res = json.load(f)
    assert set(res) == JAX_KEYS - {"note"}
    assert res["device"] == "cpu" and res["quick"] is True
    assert [(r["batch"], r["points"]) for r in res["forward"]] == [
        (1, 1024), (2, 1024), (1, 4096), (2, 4096)]
    assert [r["points"] for r in res["scaling"]] == [1024, 2048, 4096]
    for r in res["forward"] + res["scaling"]:
        assert set(r) == FORWARD_KEYS and r["memory_mb"] is None
        assert r["latency_ms"] > 0 and np.isfinite(r["throughput_pts_per_s"])
    assert set(res["hierarchical_vs_direct"]) == HIER_KEYS
    assert res["hierarchical_vs_direct"]["points"] == 4096
    samples = [res["sampling"]] + res["sampling_batched"]
    assert [(s["batch"], s["steps"], s["points"]) for s in samples] == [
        (1, 5, 4096), (2, 5, 4096)]
    for s in samples:
        assert set(s) == SAMPLING_KEYS and s["seconds_per_batch"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        res["sampling"]


@pytest.mark.parametrize("cli, argv", [
    (progress_cli, ["--checkpoint_dir", "x", "--source", "s.npy",
                    "--reference", "r.npy"]),
    (bench_cli, ["--quick"])])
def test_cli_default_device_without_card_raises(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_point_cloud_metrics_facade(rng):
    m = PointCloudMetrics(device="cpu")
    a = m.as_tensor(rng.standard_normal((2, 64, 3)))
    b = m.as_tensor(rng.standard_normal((2, 64, 3)))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(m.chamfer_distance(a, b), chamfer_distance(a, b))
    assert m.uniformity_score is metrics.uniformity_score
    assert m.earth_mover_distance_greedy is metrics.earth_mover_distance_greedy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PointCloudMetrics()


def test_logger_facade(tmp_path):
    log = Logger("pcst_logger_test", log_dir=str(tmp_path),
                 experiment_name="exp")
    log.info("hello %d", 7)
    assert log.level == logging.INFO
    for h in log.handlers:
        h.flush()
    (name,) = os.listdir(tmp_path / "exp")
    assert "hello 7" in (tmp_path / "exp" / name).read_text()
    Logger("pcst_logger_test", log_dir=str(tmp_path), experiment_name="exp")
    assert len(log.handlers) == 2  # no duplicate handlers


def test_load_checkpoint_config(tmp_path):
    mgr, cfg = experiment(tmp_path, epochs=1)
    assert load_checkpoint_config(mgr.epoch_dir(0)) == cfg
    assert load_checkpoint_config(mgr.best_dir) == cfg
    params, stats = split_state_dict(DiffusionNet(16, 8))
    other = Config(**dict(TINY, seed=3))
    path = save_checkpoint(str(tmp_path / "m.pt"), other, params, stats)
    assert load_checkpoint_config(path) == other


def test_profiling(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as logdir:
        with profiling.annotate("pcst_region"):
            torch.ones(8).sum()
    assert logdir == str(tmp_path / "t")
    text = (tmp_path / "t" / profiling.TRACE_FILE).read_text()
    assert "pcst_region" in text
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
