"""The kd-grid's flat-batched path (one structure build, one layout, one
``grid_interp`` pass and one fallback ladder for B clouds), its strip patch
and its margin diagnostics: the port vs the JAX package (Pallas kernels in
interpret mode) at (4, 4, 5) grids with 520-1,100 refs a cloud.

The port's plain kernels compute distances as XLA's CPU backend does
(``xla_cpu_distances``), so layouts, query ids, safe flags, strip ids and
fail flags must be identical, and values agree within rtol 1e-6, atol
1e-6 * max|v| (the weighted sums run in another order). The flat path must
give each cloud exactly what its own one-cloud pass gives.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.models import samplers as tsamp
from pointcloud_style_transfer_torch.ops import grid_knn as P

from torch_parity import xla_cpu_distances

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")
JS = importlib.import_module("pointcloud_style_transfer_tpu.models.samplers")

GS = (4, 4, 5)


def assert_values_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def clouds(rng, B, nq, m, C=3, scale=2.0):
    q = rng.standard_normal((B, nq, 3)).astype(np.float32) * scale
    r = rng.standard_normal((B, m, 3)).astype(np.float32) * scale
    v = rng.standard_normal((B, m, C)).astype(np.float32)
    return q, r, v


def t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_build_struct_batched_identical(rng):
    """Every table of the batched build is JAX's, and each cloud's sort
    order is its own one-cloud build's."""
    r = rng.standard_normal((3, 700, 3)).astype(np.float32)
    r[1, :70] = r[1, 70:140]  # exact duplicates: ties keep input order
    sj = J._build_struct_batched(jnp.asarray(r), GS)
    sp = P._build_struct_batched(torch.from_numpy(r), GS)
    for name, a, b in zip(P.GridStructBatched._fields, sj, sp):
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert (sp.M, sp.M_pad) == (700, 768)
    for b in range(3):
        one = P._build_struct(torch.from_numpy(r[b]), GS, skip_z_sort=True)
        assert torch.equal(sp.order_g[b * 700:(b + 1) * 700] - b * 700,
                           one.order_r)
        assert torch.equal(sp.refs_pad[b * 768:(b + 1) * 768], one.refs_pad)


def test_query_pass_batched_identical(rng):
    """One layout over both clouds' rows: values, safe flags, global query
    ids and layout coords against JAX's; each tile's runs inside its own
    cloud's part of the refs."""
    q, r, v = clouds(rng, 2, 900, 600)
    args = (3, GS, 64, 384)
    sj = J._build_struct_batched(jnp.asarray(r), GS)
    vals_j = jnp.pad(jnp.asarray(v).reshape(-1, 3)[sj[1]].reshape(2, 600, 3),
                     ((0, 0), (0, 40), (0, 0))).reshape(-1, 3)
    # op by op, as the package runs it outside jit: a compiled program
    # would fuse the margins' products into FMAs
    out_j = J._query_pass_batched(sj, jnp.asarray(q), *args, True, 1,
                                  jnp.asarray(v), 1e-8, vals_j)
    sp = P._build_struct_batched(torch.from_numpy(r), GS)
    with xla_cpu_distances():
        v_p, safe_p, qid_p, qpad_p = P._query_pass(
            sp, torch.from_numpy(q), *args, xy_halo=1,
            values=torch.from_numpy(v), eps=1e-8, layout_out=True)
    v_j, safe_j, qid_j, qpad_j = (np.asarray(a) for a in out_j)
    np.testing.assert_array_equal(qid_p.numpy(), qid_j)
    np.testing.assert_array_equal(qpad_p.numpy(), qpad_j)
    np.testing.assert_array_equal(safe_p.numpy(), safe_j)
    real = qid_j < 1800
    assert_values_close(v_p.numpy()[real], v_j[real])
    sl = P._layout_slots(sp, torch.from_numpy(q), GS, 64, 384)
    lo = sl.tb[:, None] * sp.M_pad
    busy = sl.en > sl.st
    assert (((sl.st >= lo) & (sl.en <= lo + sp.M)) | ~busy).all()
    assert int(sl.n_real.sum()) == 1800


def test_layout_batched_permutation(rng):
    """qid is a permutation of the B*Nq global ids over the real rows, JAX's
    layout exactly; assembled by qid it is each cloud's one-cloud result."""
    B, nq, m = 2, 1100, 600
    q, r, v = clouds(rng, B, nq, m)
    v_j, qid_j = J.grid_knn_interpolate_layout_batched(
        *j(q, r, v), k=3, interpret=True, grid_shape=GS)
    with xla_cpu_distances():
        v_p, qid_p = P.grid_knn_interpolate_layout_batched(
            *t(q, r, v), k=3, grid_shape=GS)
        per_cloud = torch.cat([P.grid_knn_interpolate(
            *t(q[b:b + 1], r[b:b + 1], v[b:b + 1]), k=3, grid_shape=GS)
            for b in range(B)])
    assert qid_p.dtype == torch.int32
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    real = qid_p < B * nq
    assert torch.equal(torch.sort(qid_p[real]).values,
                       torch.arange(B * nq, dtype=torch.int32))
    assert_values_close(v_p[real].numpy(), np.asarray(v_j)[np.asarray(real)])
    assembled = torch.zeros((B * nq, 3))
    assembled[qid_p[real].long()] = v_p[real]
    assert torch.equal(assembled.reshape(B, nq, 3), per_cloud)


@pytest.mark.parametrize("cap,tier", [(1024, "patched"), (16, "all_brute")])
def test_flat_batched_fallback_tiers(rng, cap, tier):
    """One clustered and one smooth cloud: the shared tier follows the
    larger unsafe count, each cloud patched against its own refs (one
    batched brute-force call), and above the last tier every row of both
    clouds is brute-forced."""
    m = 640
    r = rng.standard_normal((2, m, 3)).astype(np.float32)
    cluster = np.concatenate(
        [rng.standard_normal((900, 3)).astype(np.float32) * 0.01 + 0.001,
         rng.standard_normal((1148, 3)).astype(np.float32) * 3])
    smooth = rng.standard_normal((2048, 3)).astype(np.float32)
    q = np.stack([cluster, smooth])
    v = rng.standard_normal((2, m, 2)).astype(np.float32)
    want = J.grid_knn_interpolate(*j(q, r, v), k=3, fallback_cap=cap,
                                  interpret=True, grid_shape=GS)
    with xla_cpu_distances():
        got = P.grid_knn_interpolate(*t(q, r, v), k=3, fallback_cap=cap,
                                     grid_shape=GS)
    counts = P.unsafe_counts()[-2:]  # one entry a cloud, read in one sync
    last = P._fallback_caps(cap, 2048)[-1]
    assert counts[0] != counts[1] and min(counts) > 0
    assert (max(counts) > last) == (tier == "all_brute")
    assert (min(counts) > last) is False  # the smooth cloud follows the max
    assert got.shape == (2, 2048, 2)
    assert_values_close(got.numpy(), want)


def test_flat_batched_group_chunking(rng, monkeypatch):
    """Above the group cap both entry points chunk: ids lifted by s*Nq, the
    sentinel unified to B*Nq, a trailing group of one through the one-cloud
    layout path; the same layout and values as JAX chunked the same way,
    and the same assembly as one unchunked group."""
    B, nq, m = 5, 700, 520
    q, r, v = clouds(rng, B, nq, m)
    monkeypatch.setattr(J, "_BATCHED_MAX_GROUP", 2)
    v_j, qid_j = J.grid_knn_interpolate_layout_batched(
        *j(q, r, v), k=3, interpret=True, grid_shape=GS)
    want = J.grid_knn_interpolate(*j(q, r, v), k=3, interpret=True,
                                  grid_shape=GS)

    def assemble(v_lay, qid):
        real = qid < B * nq
        assert torch.equal(torch.sort(qid[real]).values,
                           torch.arange(B * nq, dtype=torch.int32))
        out = torch.zeros((B * nq, 3))
        out[qid[real].long()] = v_lay[real]
        return out.reshape(B, nq, 3)

    with xla_cpu_distances():
        monkeypatch.setattr(P, "_BATCHED_MAX_GROUP", 2)
        v_p, qid_p = P.grid_knn_interpolate_layout_batched(
            *t(q, r, v), k=3, grid_shape=GS)
        passes = len(P.UNSAFE_COUNTS)
        got = P.grid_knn_interpolate(*t(q, r, v), k=3, grid_shape=GS)
        assert len(P.UNSAFE_COUNTS) == passes + B  # one entry a cloud
        monkeypatch.setattr(P, "_BATCHED_MAX_GROUP", 8)
        one_group = assemble(*P.grid_knn_interpolate_layout_batched(
            *t(q, r, v), k=3, grid_shape=GS))
    np.testing.assert_array_equal(qid_p.numpy(), np.asarray(qid_j))
    real = qid_p < B * nq
    assert_values_close(v_p[real].numpy(), np.asarray(v_j)[np.asarray(real)])
    assert torch.equal(assemble(v_p, qid_p), one_group)
    assert torch.equal(got, one_group)
    assert_values_close(got.numpy(), want)


def test_batched_grid_ok_and_refusals(rng):
    assert P._batched_grid_ok(2, 1000, 600, GS, 384, 3) == \
        J._batched_grid_ok(2, 1000, 600, GS, 384, 3) is True
    for args in [(1, 1000, 600, GS, 384, 3), (2, 1000, 200, GS, 384, 3),
                 (2, 2 ** 23, 600, GS, 384, 3),
                 (2, 1000, 30000, (4, 4, 5), 384, 3)]:  # columns too long
        assert P._batched_grid_ok(*args) == J._batched_grid_ok(*args) \
            is False
    # Config(): 30k coarse points take whole columns at the defaults
    assert P._batched_grid_ok(2, 90000, 30000, P.GRID_SHAPE, P.SLOT_CAP, 3)
    q, r, v = t(*clouds(rng, 1, 100, 600))
    with pytest.raises(ValueError, match="B > 1"):
        P.grid_knn_interpolate_layout_batched(q, r, v, grid_shape=GS)
    struct = P._build_struct_batched(r.expand(2, 600, 3), GS)
    with pytest.raises(ValueError, match="layout order only"):
        P._query_pass(struct, q.expand(2, 100, 3), 3, GS, 64, 384)


def test_strip_interp_patch(rng):
    """Rows sorted by slab, one +-1-slab run a tile: ids and fail flags are
    JAX's (the window test of the TPU kernel included), values on rows the
    strip proves exact match JAX's and the brute-force interpolation."""
    m, nq, cap = 1024, 700, 256
    r = rng.standard_normal((m, 3)).astype(np.float32)
    q = rng.standard_normal((nq, 3)).astype(np.float32)
    v = rng.standard_normal((m, 3)).astype(np.float32)
    ids = np.concatenate([rng.choice(nq, cap - 40, replace=False),
                          np.full(40, nq)]).astype(np.int32)
    sj = J._build_struct(jnp.asarray(r), GS)
    vals_j = jnp.pad(jnp.asarray(v)[sj[1]], ((0, sj[10] - sj[9]), (0, 0)))
    sp = P._build_struct(torch.from_numpy(r), GS)
    vals_p = P._sorted_values(sp, torch.from_numpy(v))
    # 6 blocks: a strip of four slabs (1,024 refs) overflows its window
    for blocks in (min(64, sp.M_pad // 128), 6):
        ids_j, v_j, fail_j = (np.asarray(a) for a in J._strip_interp_patch(
            sj, GS, jnp.asarray(q), jnp.asarray(ids), vals_j, 3, 1e-8,
            interpret=True, strip_blocks=blocks, tp=128))
        with xla_cpu_distances():
            ids_p, v_p, fail_p = P._strip_interp_patch(
                sp, GS, torch.from_numpy(q), torch.from_numpy(ids), vals_p,
                3, 1e-8, strip_blocks=blocks, tp=128)
        assert ids_p.dtype == torch.int32
        np.testing.assert_array_equal(ids_p.numpy(), ids_j)
        np.testing.assert_array_equal(fail_p.numpy(), fail_j)
        good = (ids_j < nq) & ~fail_j
        assert not fail_j[ids_j >= nq].any()
        assert_values_close(v_p.numpy()[good], v_j[good])
        brute = P._brute_interp(torch.from_numpy(q), torch.from_numpy(r),
                                torch.from_numpy(v), 3, 1e-8).numpy()
        np.testing.assert_allclose(v_p.numpy()[good], brute[ids_j[good]],
                                   rtol=1e-5, atol=1e-5)
        assert good.sum() > (0 if blocks == 6 else cap // 2)
        if blocks == 6:
            assert fail_j.sum() > 0


@pytest.mark.parametrize("m,slot_cap,xy_halo",
                         [(900, 384, 1), (2200, 256, (1, 2))])
def test_query_pass_diag(rng, m, slot_cap, xy_halo):
    """The margin terms in query order, JAX's exactly: whole columns
    (msq_pair "inf", 3e38) in kNN and interpolation modes, and windowed
    z-runs in kNN mode (what examples/probe_margin_binding.py reads)."""
    q = rng.standard_normal((1500, 3)).astype(np.float32) * 2
    r = rng.standard_normal((m, 3)).astype(np.float32) * 2
    v = rng.standard_normal((m, 2)).astype(np.float32)
    fz = J._full_z_ok(m, GS, slot_cap)
    assert fz == (slot_cap == 384)
    sj = J._build_struct(jnp.asarray(r), GS, skip_z_sort=fz)
    sp = P._build_struct(torch.from_numpy(r), GS, skip_z_sort=fz)
    for values in (None, v) if fz else (None,):
        *out_j, diag_j = J._query_pass(
            sj, jnp.asarray(q), 3, GS, 64, slot_cap, True, 2, xy_halo,
            None if values is None else jnp.asarray(values), diag=True)
        with xla_cpu_distances():
            *out_p, diag_p = P._query_pass(
                sp, torch.from_numpy(q), 3, GS, 64, slot_cap, 2, xy_halo,
                None if values is None else torch.from_numpy(values),
                diag=True)
        assert sorted(diag_p) == sorted(diag_j) == [
            "d_last", "msq_pair", "msq_slab", "msq_x", "tile_ok"]
        # a run that overflows the TPU kernel's window is cut short there
        # and scanned whole here: its tile is unsafe (tile_ok False) on
        # both, and only its rows' d_last may differ
        ok = np.asarray(diag_j["tile_ok"])
        assert ok.any() and (ok.all() == fz)
        for name in diag_j:
            got, want = diag_p[name].numpy(), np.asarray(diag_j[name])
            if name == "d_last":
                got, want = got[ok], want[ok]
            np.testing.assert_array_equal(got, want, name)
        assert (np.asarray(diag_j["msq_pair"]) == np.float32(3e38)).all() \
            == fz
        unsafe = out_p[-1].numpy()
        np.testing.assert_array_equal(unsafe, np.asarray(out_j[-1]))
        safe = ~unsafe
        if values is None:
            np.testing.assert_array_equal(out_p[0].numpy()[safe],
                                          np.asarray(out_j[0])[safe])
        else:
            assert_values_close(out_p[0].numpy()[safe],
                                np.asarray(out_j[0])[safe])


def small_sampler_grids(monkeypatch):
    """Both packages' grid entry points at (4, 4, 4)/256, tq 32, fallback
    512, under which 1,024 coarse points take whole columns."""
    kw = dict(grid_shape=(4, 4, 4), tq=32, slot_cap=256, fallback_cap=512)
    for name in ("grid_knn_interpolate_layout",
                 "grid_knn_interpolate_layout_batched",
                 "grid_knn_interpolate"):
        monkeypatch.setattr(J, name, functools.partial(
            getattr(J, name), interpret=True, **kw))
        monkeypatch.setattr(P, name, functools.partial(getattr(P, name),
                                                       **kw))
    # JAX's flag-on sampler tests the default grid; the port's has no flag
    monkeypatch.setattr(J, "grid_batched_defaults_ok",
                        lambda B, Nq, M, k=3: J._batched_grid_ok(
                            B, Nq, M, (4, 4, 4), 256, k))


@pytest.mark.parametrize("flat_flag", [False, True])
def test_upsample_unknown_batched(monkeypatch, flat_flag):
    """The port's one B = 3 grid upsample (``grid_knn_interpolate``, flat,
    then ``_unpermute_assemble``) against both of JAX's, its
    PCST_SAMPLER_FLAT_BATCH off (the same route) and on (the layout
    variant and one composite-key assembly): coarse points keep their
    values exactly, the rest within the value bar, and each cloud what its
    own B = 1 upsample gives."""
    small_sampler_grids(monkeypatch)
    monkeypatch.setattr(JS, "_SAMPLER_FLAT_BATCH", flat_flag)
    rng = np.random.default_rng(1)
    B, N, M = 3, 3000, 1024
    x = rng.standard_normal((B, N, 3)).astype(np.float32) * 2
    perms = [rng.permutation(N).astype(np.int32) for _ in range(B)]
    idx = np.stack([p[:M] for p in perms])
    unknown = np.stack([p[M:] for p in perms])
    cv = rng.standard_normal((B, M, 3)).astype(np.float32)
    want = np.asarray(JS._upsample_unknown(*j(x, idx, cv), "grid",
                                           unknown=jnp.asarray(unknown)))
    passes = len(P.UNSAFE_COUNTS)
    with xla_cpu_distances():
        got = tsamp._upsample_unknown(*t(x, idx, cv), "grid",
                                      unknown=torch.from_numpy(unknown))
        assert len(P.UNSAFE_COUNTS) == passes + B  # one flat group
        one = torch.cat([tsamp._upsample_unknown(
            *t(x[b:b + 1], idx[b:b + 1], cv[b:b + 1]), "grid",
            unknown=torch.from_numpy(unknown[b:b + 1])) for b in range(B)])
    assert got.shape == (B, N, 3)
    for b in range(B):
        assert torch.equal(got[b][torch.from_numpy(idx[b]).long()],
                           torch.from_numpy(cv[b]))
    assert torch.equal(got, one)
    assert_values_close(got.numpy(), want)
