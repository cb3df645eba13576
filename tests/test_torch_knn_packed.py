"""The packed-key kNN kernels' plain versions vs the TPU kernels
(``_topk_f32packed_kernel``, ``_topk_packed_kernel``, interpret mode).

The port's plain distances are switched to XLA's CPU form
(``xla_cpu_distances``, which also gives the recomputed distances the form
XLA fuses them into under jit), so the raw keys, the decoded indices and the
recomputed distances must all be identical. Inputs carry exact duplicates
and queries on refs (zero distances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import (brute_knn, knn,
                                                 knn_f32packed_or_exact)
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops.kernels import (
    knn_f32packed, knn_f32packed_keys, knn_intpacked, knn_intpacked_keys,
    knn_topk)
from pointcloud_style_transfer_torch.ops.kernels import knn_packed as kp
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk as J

from test_torch_knn import tie_inputs
from torch_parity import xla_cpu_distances


def jax_keys_and_result(monkeypatch, fn, q, r, k, **kw):
    """Run a JAX wrapper eagerly and keep what its ``pallas_call`` returned:
    (raw keys [N_pad, k], d [N, k], i [N, k])."""
    seen = []
    orig = J.pl.pallas_call

    def spy(*args, **kwargs):
        call = orig(*args, **kwargs)

        def run(*xs):
            out = call(*xs)
            seen.append(np.asarray(out))
            return out
        return run
    monkeypatch.setattr(J.pl, "pallas_call", spy)
    with jax.disable_jit():
        d, i = fn(jnp.asarray(q), jnp.asarray(r), k, interpret=True, **kw)
    monkeypatch.undo()
    (keys,) = seen
    return keys, np.asarray(d), np.asarray(i)


CASES = [
    (600, 900, 3),    # several query tiles, one ref tile
    (300, 1000, 1),
    (200, 300, 9),
    (64, 2, 3),       # fewer refs than k: start keys / padding refs
    (257, 1024, 3),   # refs fill their tile exactly: no padding ref
]


@pytest.mark.parametrize("n,m,k", CASES)
def test_f32packed_matches_pallas(rng, monkeypatch, n, m, k):
    q, r = tie_inputs(rng, 1, n, m)
    keys_j, d_j, i_j = jax_keys_and_result(
        monkeypatch, J._knn_f32packed_single, q[0], r[0], k, tq=128, tr=512)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    with xla_cpu_distances(jit_recompute=False):  # JAX ran eagerly
        keys_t = knn_f32packed_keys(qt, rt, k, kp.padded_refs(m, 512))
        d_t, i_t = knn_f32packed(qt, rt, k, tr=512)
    assert keys_t.dtype == torch.float32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(keys_t[0].numpy().view(np.int32),
                                  keys_j[:n].view(np.int32))
    np.testing.assert_array_equal(i_t[0].numpy(), i_j)
    np.testing.assert_array_equal(d_t[0].numpy(), d_j)


@pytest.mark.parametrize("n,m,k", CASES)
def test_intpacked_matches_pallas(rng, monkeypatch, n, m, k):
    q, r = tie_inputs(rng, 1, n, m)
    keys_j, d_j, i_j = jax_keys_and_result(
        monkeypatch, J._knn_packed_single, q[0], r[0], k, tq=128, tr=512)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    with xla_cpu_distances(jit_recompute=False):  # JAX ran eagerly
        keys_t = knn_intpacked_keys(qt, rt, k, kp.padded_refs(m, 512))
        d_t, i_t = knn_intpacked(qt, rt, k, tr=512)
    assert keys_t.dtype == torch.int32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(keys_t[0].numpy(), keys_j[:n])
    np.testing.assert_array_equal(i_t[0].numpy(), i_j)
    np.testing.assert_array_equal(d_t[0].numpy(), d_j)


def test_entry_points_match_pallas(rng):
    """``knn(backend="pallas_f32packed")`` and ``brute_knn(exact=False)``
    against ``pallas_knn_f32packed`` and ``pallas_knn(exact=False)`` at
    their default tiles, batched."""
    q, r = tie_inputs(rng, 2, 300, 700)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    d_j, i_j = J.pallas_knn_f32packed(jnp.asarray(q), jnp.asarray(r), 3,
                                      interpret=True)
    with xla_cpu_distances():
        d_t, i_t = knn(qt, rt, 3, backend="pallas_f32packed")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    d_j, i_j = J.pallas_knn(jnp.asarray(q), jnp.asarray(r), 3, interpret=True,
                            exact=False)
    with xla_cpu_distances():
        d_t, i_t = brute_knn(qt, rt, 3, exact=False)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    # exact=True is the exact kernel
    for got, want in zip(brute_knn(qt, rt, 3), knn_topk(qt, rt, 3)):
        assert torch.equal(got, want)


def test_index_budget(rng):
    """2^15 refs are the most both keys index: at 32,768 the packed kernels
    run (and agree with JAX), one more and the entry points take the exact
    kernel while the single-cloud wrappers raise, as in the JAX package."""
    n, m = 40, 1 << 15
    q = rng.standard_normal((1, n, 3)).astype(np.float32)
    r = rng.standard_normal((1, m + 1, 3)).astype(np.float32)
    r[0, -5:] = q[0, :5]  # the nearest refs carry the highest indices
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    full, over = rt[:, 1:].contiguous(), rt
    d_j, i_j = J.pallas_knn_f32packed(jnp.asarray(q), jnp.asarray(r[:, 1:]), 3,
                                      interpret=True)
    with xla_cpu_distances():
        d_t, i_t = knn_f32packed_or_exact(qt, full, 3)
        d_p, i_p = brute_knn(qt, full, 3, exact=False)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert (i_t[0, :5, 0] == torch.arange(m - 5, m)).all()
    assert torch.equal(i_p[..., 0], i_t[..., 0])
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))

    exact = knn_topk(qt, over, 3)
    for got in (knn_f32packed_or_exact(qt, over, 3),
                knn(qt, over, 3, backend="pallas_f32packed"),
                brute_knn(qt, over, 3, exact=False)):
        assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])
    for fn, jfn in ((knn_f32packed, J._knn_f32packed_single),
                    (knn_intpacked, J._knn_packed_single)):
        with pytest.raises(ValueError, match="at most 2\\^15 refs"):
            fn(qt, over, 3)
        with pytest.raises(ValueError, match="at most 2\\^15 refs"):
            jfn(jnp.asarray(q[0]), jnp.asarray(r[0]), 3, interpret=True)
    # padded to 4,096 the f32-packed entry point is over budget at 28,673
    # refs; the grid's brute force pads to 2,048 and still takes it
    assert kp.padded_refs(28673, 4096) == 1 << 15
    assert kp.padded_refs(30000, 2048) <= kp.MAX_REFS


def test_nan_is_never_selected(rng):
    """A NaN distance is never taken by either key: a NaN ref is passed
    over, a NaN query keeps the start keys (decoded like k > M)."""
    q = rng.standard_normal((1, 6, 3)).astype(np.float32)
    r = rng.standard_normal((1, 20, 3)).astype(np.float32)
    r[0, 3] = q[0, 0]
    r[0, 3, 1] = np.nan  # would be query 0's nearest
    q[0, 5, 2] = np.nan
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    clean = torch.cat([rt[:, :3], rt[:, 4:]], dim=1)
    for keys_fn, fn, start in (
            (knn_f32packed_keys, knn_f32packed, kp._START_F32),
            (knn_intpacked_keys, knn_intpacked, kp._START_INT)):
        keys = keys_fn(qt, rt, 3, 2048).view(torch.int32)
        assert (keys[0, 5] == start).all()
        assert (keys[0, :5] < start).all()
        d, i = fn(qt, rt, 3)
        assert not (i[0, :5] == 3).any()
        assert torch.isnan(d[0, 5]).all() and torch.isfinite(d[0, :5]).all()
        d_c, i_c = fn(qt[:, :5], clean, 3)
        assert torch.equal(d[:, :5], d_c)
        assert torch.equal(i[:, :5], i_c + (i_c >= 3).int())


def test_selection_differs_from_exact_only_at_near_ties(rng):
    """Where the packed selection is not the exact one, the swapped
    neighbours lie within the key's resolution: 2^-8 relative for the
    f32-packed key, 2^-7 for the int-packed one."""
    q, r = tie_inputs(rng, 1, 2000, 1000)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    d_e, i_e = knn_topk(qt, rt, 3)
    for fn, res in ((knn_f32packed, 2.0 ** -8), (knn_intpacked, 2.0 ** -7)):
        d_p, i_p = fn(qt, rt, 3)
        assert (d_p >= d_e).all()  # the exact ones are the nearest
        assert (d_p <= d_e * (1 + res) + 1e-37).all()


def test_grid_knn_inexact_matches_jax(rng):
    """``grid_knn(exact=False)``: the fallback rows go through the
    f32-packed kernel; identical to the JAX package with a small grid."""
    import importlib
    from test_torch_grid_knn import GRID, clustered
    JG = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")
    q, r, _ = clustered(rng)
    d_j, i_j = JG.grid_knn(jnp.asarray(q)[None], jnp.asarray(r)[None], k=3,
                           interpret=True, exact=False, **GRID)
    with xla_cpu_distances():
        d_p, i_p = P.grid_knn(torch.from_numpy(q)[None],
                              torch.from_numpy(r)[None], k=3, exact=False,
                              **GRID)
    assert P.UNSAFE_COUNTS[-1] > 0
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))
    # too few refs for the grid: the f32-packed brute force
    d_s, i_s = P.grid_knn(torch.from_numpy(q)[None], torch.from_numpy(r)[None,
                          :40], k=3, exact=False)
    d_b, i_b = knn_f32packed(torch.from_numpy(q)[None],
                             torch.from_numpy(r)[None, :40].contiguous(), 3,
                             tr=2048)
    assert torch.equal(d_s, d_b) and torch.equal(i_s, i_b)
