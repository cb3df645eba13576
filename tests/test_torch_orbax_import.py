"""JAX checkpoints into the port: a tiny JAX trainer state saved by the JAX
package's orbax ``CheckpointManager``, converted by
``tools/orbax_to_torch.py``, read back by the port's
``CheckpointManager.restore`` and ``load_for_inference`` (every tensor and
counter exactly); the port's error on an unconverted JAX directory; and
``utils/cache.py``'s build-directory redirect (no ``nvcc`` needed: the path
the builder would write).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config as PortConfig
from pointcloud_style_transfer_torch.convert import train_state_to_torch
from pointcloud_style_transfer_torch.ops.kernels import _common
from pointcloud_style_transfer_torch.utils.cache import \
    enable_compilation_cache
from pointcloud_style_transfer_torch.utils.checkpoint import (
    CheckpointManager, load_for_inference)
from pointcloud_style_transfer_tpu.config import Config
from pointcloud_style_transfer_tpu.utils.checkpoint import \
    CheckpointManager as JaxCheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(total_points=256, global_points=64, feature_dim=16,
            time_embed_dim=8, num_timesteps=20, use_amp=False, num_workers=0,
            val_interval=1, warmup_epochs=1, gradient_accumulation_steps=2)


def tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_state(template, seed: int):
    """A concrete trainer state shaped like ``template``: every float leaf
    drawn, every integer leaf (the optimizer's counters) a distinct
    count, so that no swapped or dropped entry can pass."""
    rng = np.random.default_rng(seed)
    ints = iter(range(3, 1000))

    def leaf(x):
        if np.issubdtype(x.dtype, np.integer):
            return jnp.full(x.shape, next(ints), x.dtype)
        return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
    return jax.tree_util.tree_map(leaf, template)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Two epochs of a JAX experiment (epoch 1 the best) and their states."""
    tmp = tmp_path_factory.mktemp("orbax")
    cfg = Config(**TINY, experiment_name="toy",
                 checkpoint_dir=str(tmp / "jax"))
    template = tool().state_template(cfg)
    mgr = JaxCheckpointManager(cfg.checkpoint_dir, cfg.experiment_name)
    states = [random_state(template, s) for s in range(2)]
    for epoch, state in enumerate(states):
        mgr.save(state, epoch, cfg, is_best=epoch == 1,
                 best_val_loss=0.5 - 0.25 * epoch)
    return tmp, cfg, mgr, states


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


def test_experiment_round_trip(saved):
    tmp, cfg, mgr, states = saved
    out = tmp / "port"
    written = tool().convert(mgr.base_dir, str(out))
    assert [os.path.basename(p) for p in written] == [
        "best_model", "ckpt_epoch_0000", "ckpt_epoch_0001"]
    port = CheckpointManager(str(tmp / "port"), "")
    assert port.list_epochs() == [0, 1]
    for epoch, state in enumerate(states):
        got, meta = CheckpointManager.restore(port.epoch_dir(epoch))
        assert_tree_equal(got, train_state_to_torch(state))
        assert meta["epoch"] == epoch
        assert meta["best_val_loss"] == 0.5 - 0.25 * epoch
        assert meta["config"] == cfg.to_dict()
        opt, jopt = got["opt_state"], state["opt_state"]
        adam = next(s for s in jopt.inner_opt_state if hasattr(s, "mu"))
        assert (opt["mini_step"], opt["gradient_step"], opt["count"]) == (
            int(jopt.mini_step), int(jopt.gradient_step), int(adam.count))
    best, _ = CheckpointManager.restore(str(out / "best_model"))
    assert_tree_equal(best, train_state_to_torch(states[1]))
    _, meta, nxt = port.load_latest()
    assert (meta["epoch"], nxt) == (1, 2)

    config, model = load_for_inference(str(out / "best_model"), device="cpu")
    assert config == PortConfig.from_dict(cfg.to_dict())
    want = {**best["ema_params"], **best["batch_stats"]}
    sd = model.net.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k].float(), v.float()), k


def test_one_directory(saved, tmp_path):
    _, _, mgr, states = saved
    path = str(tmp_path / "best")
    assert tool().main(["--checkpoint", mgr.best_dir, "--output", path]) == 0
    got, meta = CheckpointManager.restore(path)
    assert_tree_equal(got, train_state_to_torch(states[1]))
    assert meta["epoch"] == 1
    # an existing output is replaced only on request, and then whole
    with pytest.raises(FileExistsError, match="--overwrite"):
        tool().main(["--checkpoint", mgr._epoch_dir(0), "--output", path])
    (tmp_path / "best" / "stale").write_text("x")
    assert tool().main(["--checkpoint", mgr._epoch_dir(0), "--output", path,
                        "--overwrite"]) == 0
    got, meta = CheckpointManager.restore(path)
    assert_tree_equal(got, train_state_to_torch(states[0]))
    assert meta["epoch"] == 0
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    assert sorted(os.listdir(tmp_path)) == ["best"]  # no temporary left


def tree_listing(root):
    return sorted((d, tuple(sorted(f)), os.path.getsize(os.path.join(d, f[0]))
                   if f else 0) for d, _, f in os.walk(root))


@pytest.mark.parametrize("where", ["same", "inside", "holds"])
def test_refuses_output_overlapping_checkpoint(saved, where):
    """Converting in place (the output the checkpoint, inside it or around
    it) is refused before anything is written, even with --overwrite: the
    JAX checkpoint stays as it was."""
    _, _, mgr, _ = saved
    src = mgr.best_dir
    dst = {"same": src, "inside": os.path.join(src, "port"),
           "holds": os.path.dirname(src)}[where]
    before = tree_listing(mgr.base_dir)
    for extra in ([], ["--overwrite"]):
        with pytest.raises(ValueError, match="choose another directory"):
            tool().main(["--checkpoint", src, "--output", dst, *extra])
    assert tree_listing(mgr.base_dir) == before


def test_unconverted_directory_names_the_converter(saved):
    _, _, mgr, _ = saved
    for call in (lambda: CheckpointManager.restore(mgr.best_dir),
                 lambda: load_for_inference(mgr.best_dir, device="cpu")):
        with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
            call()


def test_compilation_cache_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_common, "BUILD_ROOT", _common.BUILD_ROOT)
    monkeypatch.delenv("PCST_TORCH_KERNEL_CACHE", raising=False)
    # the JAX package's XLA cache variable is never the port's build dir
    monkeypatch.setenv("PCST_COMPILATION_CACHE", str(tmp_path / "xla"))
    default = _common.BUILD_ROOT
    assert default.parts[-2:] == ("build", "torch_kernels")
    assert enable_compilation_cache() == default
    assert _common.library_path("grid_fused").parent.parent == default
    assert enable_compilation_cache(str(tmp_path / "a")) == tmp_path / "a"
    assert _common.library_path("grid_fused").parent.parent == tmp_path / "a"
    # a bare call keeps an earlier redirect
    assert enable_compilation_cache() == tmp_path / "a"
    monkeypatch.setenv("PCST_TORCH_KERNEL_CACHE", str(tmp_path / "b"))
    enable_compilation_cache()
    lib = _common.library_path("knn_topk", ("-DPCST_X=1",))
    assert lib.parent.parent == tmp_path / "b"
    assert lib.name == "libknn_topk.so"
