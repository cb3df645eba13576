"""kd-grid structure and query layout: the port's ``ops/grid_knn.py`` vs the
JAX package's, on numpy-seeded clouds with exact duplicate refs and queries
placed exactly on refs.

* ``_partition_tables`` and ``_build_struct`` (both ``skip_z_sort`` modes):
  every table identical.
* ``_query_pass`` in all three slot shapes (y-run slots, whole-column pairs,
  windowed z-runs) and with int and tuple ``xy_halo``: identical layout
  ``qid``, identical ``safe`` flags, and on safe rows identical distances
  and neighbour ids, interpolated values within rtol 1e-6 and
  atol 1e-6 * max|v|. The JAX kernels run in interpret mode, where XLA's
  CPU backend contracts the distance into FMAs; the port's plain kernels
  are switched to that same arithmetic (``xla_cpu_distances``) so that the
  comparison is bit for bit. The test with the port's own arithmetic holds
  it to the same flags and ids, distances within 3e-7 relative.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn as P

from torch_parity import xla_cpu_distances

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

# (slot shape, grid_shape, slot_cap, xy_halo, M, Nq)
CASES = [
    ("yrun", (4, 4, 5), 384, 1, 2000, 3000),
    ("yrun_halo12", (4, 4, 5), 384, (1, 2), 2000, 3000),
    ("columns", (1, 2, 5), 512, 1, 700, 1500),
    ("windowed", (4, 4, 5), 128, 1, 2000, 3000),
]


def clouds(rng, m, nq):
    r = (rng.standard_normal((m, 3)) * 2).astype(np.float32)
    q = (rng.standard_normal((nq, 3)) * 2).astype(np.float32)
    r[rng.choice(m, m // 10, replace=False)] = r[rng.choice(m, m // 10)]
    q[: nq // 10] = r[rng.choice(m, nq // 10)]
    v = rng.standard_normal((m, 3)).astype(np.float32)
    return q, r, v


def assert_struct_equal(sj, sp):
    assert len(sj) == len(sp)
    for name, a, b in zip(P.GridStruct._fields, sj, sp):
        if isinstance(a, int):
            assert a == b, name
        else:
            np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a),
                                          err_msg=name)


@pytest.mark.parametrize("M,grid_shape", [(30000, (16, 12, 8)),
                                          (2000, (4, 4, 5)), (700, (1, 2, 5)),
                                          (61, (3, 2, 7))])
def test_partition_tables_identical(M, grid_shape):
    for a, b in zip(J._partition_tables(M, *grid_shape),
                    P._partition_tables(M, *grid_shape)):
        np.testing.assert_array_equal(a, b)
    for cap in (128, 256, 384, 512):
        assert J._full_z_ok(M, grid_shape, cap) == P._full_z_ok(
            M, grid_shape, cap)


@pytest.mark.parametrize("skip_z_sort", [False, True])
@pytest.mark.parametrize("M,grid_shape", [(2000, (4, 4, 5)),
                                          (700, (1, 2, 5))])
def test_build_struct_identical(rng, M, grid_shape, skip_z_sort):
    _, r, _ = clouds(rng, M, 10)
    assert_struct_equal(
        J._build_struct(jnp.asarray(r), grid_shape, skip_z_sort),
        P._build_struct(torch.from_numpy(r), grid_shape, skip_z_sort))


def passes(rng, grid_shape, slot_cap, xy_halo, M, Nq, tq=64):
    """The JAX and port structures and query inputs of one case."""
    q, r, v = clouds(rng, M, Nq)
    fz = J._full_z_ok(M, grid_shape, slot_cap)
    sj = J._build_struct(jnp.asarray(r), grid_shape, skip_z_sort=fz)
    sp = P._build_struct(torch.from_numpy(r), grid_shape, skip_z_sort=fz)
    args = (3, grid_shape, tq, slot_cap)
    kw = dict(full_z=True if fz else None)
    return q, v, sj, sp, args, kw


@pytest.mark.parametrize("shape,grid_shape,slot_cap,xy_halo,M,Nq", CASES)
def test_query_pass_layout_identical(rng, shape, grid_shape, slot_cap,
                                     xy_halo, M, Nq):
    q, v, sj, sp, args, kw = passes(rng, grid_shape, slot_cap, xy_halo, M, Nq)
    sl = P._layout_slots(sp, torch.from_numpy(q), grid_shape, 64, slot_cap,
                         2, xy_halo, kw["full_z"])
    Hx, Hy = (xy_halo, xy_halo) if isinstance(xy_halo, int) else xy_halo
    n_slots = 2 * Hx + 1 if shape.startswith("yrun") else (
        (2 * Hx + 1) * (2 * Hy + 1))
    assert sl.st.shape[1] == n_slots
    assert (sl.pairs is not None) == (shape == "windowed")
    if shape == "windowed":
        assert not sl.tile_ok.all()  # some windows overflow: rows unsafe

    v_j, safe_j, qid_j, qpad_j = J._query_pass(
        sj, jnp.asarray(q), *args, True, 2, xy_halo, jnp.asarray(v), 1e-8,
        layout_out=True, **kw)
    with xla_cpu_distances():
        v_p, safe_p, qid_p, qpad_p = P._query_pass(
            sp, torch.from_numpy(q), *args, 2, xy_halo, torch.from_numpy(v),
            1e-8, layout_out=True, **kw)
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    np.testing.assert_array_equal(qpad_p.numpy(), np.asarray(qpad_j))
    np.testing.assert_array_equal(safe_p.numpy(), np.asarray(safe_j))
    safe = safe_p.numpy()
    assert safe.sum() > 0
    v_j = np.asarray(v_j)
    np.testing.assert_allclose(v_p.numpy()[safe], v_j[safe], rtol=1e-6,
                               atol=1e-6 * np.abs(v_j[safe]).max())


@pytest.mark.parametrize("shape,grid_shape,slot_cap,xy_halo,M,Nq", CASES)
def test_query_pass_knn_identical(rng, shape, grid_shape, slot_cap, xy_halo,
                                  M, Nq):
    q, v, sj, sp, args, kw = passes(rng, grid_shape, slot_cap, xy_halo, M, Nq)
    d_j, i_j, u_j = (np.asarray(a) for a in J._query_pass(
        sj, jnp.asarray(q), *args, True, 2, xy_halo, **kw))
    with xla_cpu_distances():
        d_p, i_p, u_p = P._query_pass(sp, torch.from_numpy(q), *args, 2,
                                      xy_halo, **kw)
    np.testing.assert_array_equal(u_p.numpy(), u_j)
    ok = ~u_j
    np.testing.assert_array_equal(d_p.numpy()[ok], d_j[ok])
    np.testing.assert_array_equal(i_p.numpy()[ok], i_j[ok])
    assert i_p.dtype == torch.int32 and d_p.dtype == torch.float32

    # the port's own arithmetic (no FMA): same flags and ids on this data,
    # distances within 3e-7 relative (XLA's FMAs move the last bit or two)
    d_n, i_n, u_n = P._query_pass(sp, torch.from_numpy(q), *args, 2, xy_halo,
                                  **kw)
    np.testing.assert_array_equal(u_n.numpy(), u_j)
    np.testing.assert_array_equal(i_n.numpy()[ok], i_j[ok])
    np.testing.assert_allclose(d_n.numpy()[ok], d_j[ok], rtol=3e-7, atol=0)


def test_full_z_refused_when_columns_overflow(rng):
    q, r, _ = clouds(rng, 2000, 300)
    sp = P._build_struct(torch.from_numpy(r), (4, 4, 5))
    with pytest.raises(ValueError, match="full_z requires"):
        P._query_pass(sp, torch.from_numpy(q), 3, (4, 4, 5), 64, 128,
                      full_z=True)
