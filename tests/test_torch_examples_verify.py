"""The port's two exactness checks (``examples/verify_grid_torch.py``,
``examples/verify_sharded_torch.py``) on the CPU at a tiny size: 1,024
queries or points, 256 refs or coarse points, widths 32 / 16, float32, the
grid at (4, 4, 2) / 256, tq 64 (``PCST_PROF_*``), under which 256 refs
engage it with whole columns and leave it rows it cannot prove exact.

* ``verify_grid_torch``: all four gates OK (the batched one run, not
  skipped); a negative control whose fallback ladder leaves the unsafe
  rows as the grid found them reports a gate FAILED.
* ``verify_sharded_torch`` on a 2-rank gloo group (``tests/torch_dist.py``),
  2 steps: gate 1 within 1e-4, gate 2 met, the default backend the grid,
  both ranks the same; its single-device assembly within 1e-5 of JAX's
  ``_upsample_unknown`` (the JAX grid in interpret mode at the same grid)
  on the same step inputs; a negative control that offsets each rank's
  query slice by one shard (as ``tests/test_sharding.py`` does to the
  JAX package) fails gate 1.
"""

import functools
import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from pointcloud_style_transfer_torch.ops import grid_knn

import torch_parity  # noqa: F401  (shares the cores among workers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import verify_grid_torch as verify_grid  # noqa: E402

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")
JS = importlib.import_module("pointcloud_style_transfer_tpu.models.samplers")

GRID = dict(grid_shape=(4, 4, 2), tq=64, slot_cap=256)
ENV = {"PCST_PROF_GRID": "4,4,2", "PCST_PROF_TQ": "64",
       "PCST_PROF_SLOT_CAP": "256"}
SIZE = ["1024", "256", "3", "--device", "cpu"]


@pytest.fixture
def small_grid(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def test_verify_grid_gates_ok(small_grid, capsys):
    res = verify_grid.main(SIZE)
    assert res["ok"] and res["knobs"]["grid_shape"] == (4, 4, 2)
    g = res["gates"]
    assert list(g) == ["knn", "interp", "layout", "batched"]
    assert g["knn"]["max_d_diff"] == 0.0 and g["knn"]["of"] == 1024 * 3
    assert g["interp"]["max_err"] < verify_grid.INTERP_BAR
    assert g["layout"]["perm_ok"] and g["layout"]["max_diff"] <= 1e-6
    assert not g["batched"]["skipped"] and g["batched"]["perm_ok"]
    out = capsys.readouterr().out
    for name in ("kNN", "interp", "layout", "batched"):
        assert f"EXACTNESS ({name}): OK" in out


def test_verify_grid_fails_without_the_fallback(small_grid, monkeypatch,
                                                capsys):
    """The ladder's patch dropped: the rows the grid could not prove
    exact keep its own answer, and a gate says so."""
    passes = len(grid_knn.UNSAFE_COUNTS)
    monkeypatch.setattr(grid_knn, "_patched",
                        lambda outs, patch, dest, count: outs)
    res = verify_grid.main(SIZE)
    assert sum(grid_knn.unsafe_counts()[passes:]) > 0
    assert not res["ok"]
    failed = [n for n, g in res["gates"].items() if not g["ok"]]
    assert failed
    assert "FAILED" in capsys.readouterr().out


def test_verify_grid_skips_the_batched_gate_where_it_does_not_apply(
        monkeypatch):
    monkeypatch.setenv("PCST_PROF_GRID", "4,4,2")
    monkeypatch.setenv("PCST_PROF_TQ", "64")
    monkeypatch.setenv("PCST_PROF_SLOT_CAP", "128")  # windowed z-runs
    res = verify_grid.main(SIZE)
    assert res["gates"]["batched"] == {"skipped": True, "B": 4, "ok": True}


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    try:
        return torch_dist.run_group(torch_dist.verify_sharded_ranks, 2,
                                    tmp_path_factory.mktemp("verify"))
    finally:
        mp.undo()


def test_verify_sharded_two_ranks(sharded_ranks):
    for r in sharded_ranks:
        assert r["run.ranks"] == 2 and r["backend_is_grid"]
        assert r["run.gate1_ok"] and r["run.gate1_diff"] <= 1e-4
        assert r["run.gate2_ok"] and r["run.ok"]
        assert r["run.chamfer"] <= max(3 * r["run.floor"], 1e-4)
    a, b = sharded_ranks
    np.testing.assert_array_equal(a["run.sharded"], b["run.sharded"])
    assert a["run.chamfer"] == b["run.chamfer"]


def test_verify_sharded_shard_offset_fails_gate_1(sharded_ranks):
    for r in sharded_ranks:
        assert not r["offset.gate1_ok"] and not r["offset.ok"]
        assert r["offset.gate1_diff"] > 1e-4


def test_verify_sharded_assembly_matches_jax(sharded_ranks, monkeypatch):
    monkeypatch.setattr(J, "grid_knn_interpolate_layout", functools.partial(
        J.grid_knn_interpolate_layout, interpret=True, **GRID))
    s = {k[len("step."):]: v for k, v in sharded_ranks[0].items()
         if k.startswith("step.")}
    want = JS._upsample_unknown(
        jnp.asarray(s["x0"]), jnp.asarray(s["x_idx"]),
        jnp.asarray(s["guided"]), "grid", unknown=jnp.asarray(s["x_unk"]),
        ref_xyz=jnp.asarray(s["x_coarse"]),
        unknown_xyz=jnp.asarray(s["x_unk_xyz"]))
    np.testing.assert_allclose(sharded_ranks[0]["fused"], np.asarray(want),
                               rtol=0, atol=1e-5)
