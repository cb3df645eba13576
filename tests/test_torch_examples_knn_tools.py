"""The port's kNN and grid tools (``examples/*_torch.py``) against the JAX
package on the CPU at a tiny size (1,024 points, 256 coarse, widths 32 /
16, float32; 900 x 300 and 1,024 x 256 clouds), the JAX Pallas kernels in
interpret mode and the port's plain distances in XLA's CPU form
(``xla_cpu_distances``) where selections are held:

* ``probe_margin_binding_torch``: along the port's trajectory, drawn from
  JAX's keys (``test_torch_examples_probe.jax_draws``), every step's nine
  counts equal the JAX probe's expressions on JAX's
  ``_query_pass(diag=True)`` at that step's points, at (4, 4, 2) / 128
  with z halo 2 and (4, 4, 4) / 128 with z halo 0 (windowed z-runs, no run
  past its window), with at least one ``binds_*`` count nonzero;
* ``profile_grid_knn_torch``: the core's unsafe rows are JAX's
  ``_grid_knn_core``'s, ``_grid_knn_single``'s indices JAX's and its
  distances within 1e-6, and the stubbed plumbing launches no
  ``grid_topk``;
* ``profile_batched_interp_torch``: ``flat`` within 1e-6 of ``percloud``
  at B = 2, ``flat_nofb`` launching no ``knn_topk``;
* ``bench_knn_backends_torch``: each backend held to JAX's
  ``knn(backend="pallas")`` under the tie rule of ``ops/distance.py::knn``
  (``pallas``, ``grid`` and ``pallas_pruned``: distances identical,
  indices identical but where the distances tie exactly;
  ``pallas_f32packed``: other choices only at near-ties within 2^-8
  relative distance, its recomputed distances within rtol 1e-6 of JAX's
  where the choice is the same); fresh refs are a new tensor each call, made from
  the call before; a backend that raises is returned under ``failed``.
"""

import functools
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import make_schedule
from pointcloud_style_transfer_torch.ops import distance, grid_knn
from pointcloud_style_transfer_torch.ops.kernels import LAUNCH_COUNTS
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import pallas_knn

from torch_parity import xla_cpu_distances

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import bench_knn_backends_torch as bench  # noqa: E402
import probe_margin_binding_torch as margin  # noqa: E402
import profile_batched_interp_torch as batched  # noqa: E402
import profile_common_torch as common  # noqa: E402
import profile_grid_knn_torch as grid_stages  # noqa: E402
from test_torch_examples_probe import TINY, jax_draws  # noqa: E402

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

STEPS = 3
CPU = ["--device", "cpu"]
# a grid whose whole columns 256-300 refs engage, leaving rows to patch
SMALL_GRID = {"PCST_PROF_GRID": "4,4,2", "PCST_PROF_SLOT_CAP": "256",
              "PCST_PROF_TQ": "64"}


def counted(name, fn):
    def wrapper(*args, **kwargs):
        LAUNCH_COUNTS[name] += 1
        return fn(*args, **kwargs)
    return wrapper


@pytest.fixture
def kernels_counted(monkeypatch):
    """The grid module's kernel wrappers counted, as the card counts
    them."""
    for name in ("grid_interp", "grid_topk", "knn_topk"):
        monkeypatch.setattr(grid_knn, name,
                            counted(name, getattr(grid_knn, name)))


def jax_counts(q, r, knobs):
    """The JAX probe's nine counts on JAX's diag pass at (q, r), jitted as
    the JAX probe's step is."""
    gs = knobs["grid_shape"]

    @jax.jit
    def counts(q, r):
        struct = J._build_struct(r, gs)
        _, _, unsafe, dg = J._query_pass(struct, q, 3, gs, knobs["tq"],
                                         knobs["slot_cap"], True,
                                         knobs["z_halo"], 1, diag=True)
        return binding_counts(unsafe, dg)
    return [int(c) for c in counts(jnp.asarray(q), jnp.asarray(r))]


def binding_counts(unsafe, dg):
    """The JAX probe's expressions, copied."""
    dk = dg["d_last"]
    sentinel = dk >= 1e29
    window = ~dg["tile_ok"]
    margin_only = unsafe & ~sentinel & ~window
    mx, ms, mp = dg["msq_x"], dg["msq_slab"], dg["msq_pair"]
    binds_x = margin_only & (mx <= ms) & (mx <= mp)
    binds_s = margin_only & ~binds_x & (ms <= mp)
    binds_p = margin_only & ~binds_x & ~binds_s
    resc_x = margin_only & (dk <= jnp.minimum(ms, mp))
    resc_s = margin_only & (dk <= jnp.minimum(mx, mp))
    resc_p = margin_only & (dk <= jnp.minimum(mx, ms))
    return jnp.stack([jnp.sum(m) for m in (
        unsafe, sentinel, window & ~sentinel, binds_x, binds_s, binds_p,
        resc_x, resc_s, resc_p)])


@pytest.mark.parametrize("grid,z_halo", [((4, 4, 2), 2), ((4, 4, 4), 0)])
def test_margin_counts_match_the_jax_probe(grid, z_halo):
    knobs = {**common.grid_knobs({}), "grid_shape": grid, "slot_cap": 128,
             "z_halo": z_halo}
    model = common.random_model("cpu", config=Config(**TINY))
    states = []
    with torch.no_grad(), xla_cpu_distances():
        counts = margin.trajectory(
            model, make_schedule(model.config), jax_draws(), STEPS, knobs,
            on_step=lambda s, q, r: states.append((q.numpy().copy(),
                                                   r.numpy().copy())))
    assert not grid_knn._full_z_ok(256, grid, 128)  # windowed z-runs
    want = [jax_counts(q, r, knobs) for q, r in states]
    assert counts == want
    by_name = np.array(counts).sum(0)
    assert by_name[0] > 0 and by_name[3:6].sum() > 0
    # every margin-only unsafe row binds on exactly one term
    assert (by_name[0] - by_name[1] - by_name[2]) == by_name[3:6].sum()


def test_margin_probe_main_prints_every_step(monkeypatch, capsys):
    for k, v in {"PCST_PROF_GRID": "4,4,4", "PCST_PROF_SLOT_CAP": "128",
                 "PCST_PROF_Z_HALO": "0"}.items():
        monkeypatch.setenv(k, v)
    res = margin.main(["2", *CPU, "--config",
                       *(f"{k}={v}" for k, v in TINY.items())])
    assert res["t"] == [999, 0] and len(res["counts"]) == 2
    assert list(res["totals"]) == list(margin.NAMES)
    out = capsys.readouterr().out
    assert "step   1 t=   0 unsafe=" in out and "binds_pair" in out


GRID_KNOBS = {**common.grid_knobs({}), "grid_shape": (4, 4, 2),
              "slot_cap": 128, "tq": 64}


def test_grid_knn_stages_match_jax(kernels_counted):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((900, 3)).astype(np.float32) * 0.9
    r = rng.standard_normal((300, 3)).astype(np.float32) * 0.9
    k = GRID_KNOBS
    with xla_cpu_distances():
        res = grid_stages.stages(torch.from_numpy(q), torch.from_numpy(r),
                                 chain=1, reps=1, knobs=k)
    core = jax.jit(functools.partial(
        J._grid_knn_core, k=3, grid_shape=k["grid_shape"], tq=k["tq"],
        slot_cap=k["slot_cap"], interpret=True, exact=True,
        z_halo=k["z_halo"]))
    want_unsafe = int(jnp.sum(core(jnp.asarray(q), jnp.asarray(r))[2]))
    assert res["unsafe_rows"] == want_unsafe > 0
    d_j, i_j = J._grid_knn_single(
        jnp.asarray(q), jnp.asarray(r), 3, k["grid_shape"], k["tq"],
        k["slot_cap"], k["fallback_cap"], True, True, k["z_halo"])
    d_p, i_p = res["full"]
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-6)
    st = res["stages"]
    assert list(st) == ["core", "structure", "layout", "kernel", "unsort",
                        "order_r", "plumbing", "full"]
    assert st["core"]["launches"] == {"grid_topk": 1}
    assert st["plumbing"]["launches"] == {}  # the kernel stubbed
    assert st["full"]["launches"] == {"grid_topk": 1, "knn_topk": 1}
    assert st["kernel"]["launches"] == {"grid_topk": 1}
    assert all(np.isfinite(s["ms"]) for s in st.values())


def test_grid_knn_main(small_grid):
    res = grid_stages.main(["--queries", "900", "--refs", "300", "--chain",
                            "2", "--reps", "1", *CPU])
    assert res["knobs"]["grid_shape"] == (4, 4, 2) and res["full_z"]
    assert res["unsafe_rows"] > 0
    assert set(res["kernel_in_context"]) == {"ms", "noise_ms", "resolved"}


def test_batched_interp_flat_matches_cloud_by_cloud(small_grid,
                                                    kernels_counted):
    res = batched.main(["1", "2", "--queries", "900", "--refs", "300",
                        "--chain", "2", "--reps", "1", *CPU])
    two = res["by_batch"][2]
    assert two["flat_batched"] and not res["by_batch"][1]["flat_batched"]
    np.testing.assert_allclose(two["flat"]["out"].numpy(),
                               two["percloud"]["out"].numpy(), rtol=0,
                               atol=1e-6)
    assert two["flat"]["launches"] == {"grid_interp": 1, "knn_topk": 1}
    assert two["percloud"]["launches"] == {"grid_interp": 2, "knn_topk": 2}
    assert two["flat_nofb"]["launches"] == {"grid_interp": 1}
    assert two["flat_nofb"]["out"].shape[1] == 3
    for B, by in res["by_batch"].items():
        for v in batched.VARIANTS:
            assert by[v]["ms_per_cloud"] == pytest.approx(by[v]["ms"] / B)


@pytest.fixture
def small_grid(monkeypatch):
    for k, v in SMALL_GRID.items():
        monkeypatch.setenv(k, v)


def test_bench_backends_held_to_jax_pallas(small_grid):
    """The port's distances in XLA's CPU form: ``pallas``, ``grid`` and
    ``pallas_pruned`` give JAX's distances bit for bit and its indices but
    where the distances tie exactly (``pallas_pruned`` with its own tie
    order, the Morton window's); ``pallas_f32packed`` its indices but at
    near-ties, where the distances lie within 2^-8 relative of JAX's."""
    nq, m = 1024, 256
    with xla_cpu_distances():
        res = bench.main([str(nq), str(m), "3", "pallas",
                          "pallas_f32packed", "grid", "pallas_pruned",
                          "--chain", "2", "--reps", "1", *CPU])
    assert not res["failed"] and list(res["backends"]) == [
        "pallas", "pallas_f32packed", "grid", "pallas_pruned"]
    g = torch.Generator().manual_seed(common.SEED)
    q = torch.randn((1, nq, 3), generator=g) * 0.9
    r = torch.randn((1, m, 3), generator=g) * 0.9
    d_j, i_j = map(np.asarray, pallas_knn(jnp.asarray(q.numpy()),
                                          jnp.asarray(r.numpy()), 3,
                                          interpret=True))
    for b, rd in res["backends"].items():
        d, i = rd["d"].numpy(), rd["i"].numpy()
        assert np.isfinite(rd["ms"]) and rd["ms"] > 0, b
        if b == "pallas_f32packed":
            # its distances are recomputed as (dx^2 + dy^2) + dz^2 of the
            # chosen refs, the exact kernel's as dx^2 + (dy^2 + dz^2):
            # within float32 rounding where the choice is the same
            same = i == i_j
            np.testing.assert_allclose(d[same], d_j[same], rtol=1e-6,
                                       err_msg=b)
            assert (np.abs(d - d_j) <= 2.0 ** -8 * d_j).all(), b
            continue
        np.testing.assert_array_equal(d, d_j, err_msg=b)
        assert ((i == i_j) | (d == d_j)).all(), b
        if b != "pallas_pruned":
            np.testing.assert_array_equal(i, i_j, err_msg=b)


@pytest.mark.parametrize("fresh", [False, True])
def test_bench_fresh_refs(monkeypatch, fresh):
    seen = []

    def knn(q, r, k, backend):
        seen.append(r)
        return distance.knn(q, r, k, backend=backend)
    monkeypatch.setattr(bench, "knn", knn)
    q, r = torch.randn(1, 200, 3), torch.randn(1, 64, 3)
    body = bench.chained("pallas", 3, 3, fresh)
    body({"q": q, "r": r})
    assert len(seen) == 3 and seen[0] is r
    for prev, cur in zip(seen, seen[1:]):
        assert (cur is not prev) == fresh
    if fresh:
        d = distance.knn(q, seen[1], 3)[0]
        assert torch.equal(seen[2], seen[1] + d[..., :1, :1] * 1e-12)


def test_bench_failed_backend_is_returned(capsys):
    res = bench.main(["256", "64", "3", "pallas", "no_such_backend",
                      "--chain", "1", "--reps", "1", *CPU])
    assert list(res["backends"]) == ["pallas"]
    assert "unknown knn backend" in res["failed"]["no_such_backend"]
    assert "no_such_backend      FAILED" in capsys.readouterr().out
