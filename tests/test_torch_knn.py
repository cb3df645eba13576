"""kNN: the kernel's plain PyTorch version vs the TPU kernel
(``pallas_knn``, interpret mode) with ties and exact duplicates. Indices
identical; squared distances within 1e-6 relative (the same float32
squared-difference arithmetic, so in practice bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import knn
from pointcloud_style_transfer_torch.ops.kernels import knn_topk, knn_topk_plain
from pointcloud_style_transfer_tpu.ops.pallas import pallas_knn
from torch_parity import xla_cpu_distances


def tie_inputs(rng, b, n, m):
    """Refs with exact duplicates (equal-distance ties at every query) and
    queries that sit exactly on refs (zero distances, tied between
    duplicate refs), plus a grid-aligned block whose distances tie."""
    r = (rng.standard_normal((b, m, 3)) * 2).astype(np.float32)
    q = (rng.standard_normal((b, n, 3)) * 2).astype(np.float32)
    n_dup = max(1, m // 5)
    r[:, rng.choice(m, n_dup, replace=False)] = r[:, rng.choice(m, n_dup)]
    q[:, : n // 4] = r[:, rng.choice(m, n // 4)]
    g = np.round(r[:, : m // 4] * 2) / 2  # lattice points: many equal distances
    r[:, : m // 4] = g
    q[:, n // 4: n // 2] = np.round(q[:, n // 4: n // 2] * 2) / 2 + 0.25
    return q, r


@pytest.mark.parametrize("b,n,m,k", [
    (2, 300, 200, 3),   # one tile each
    (1, 513, 4100, 3),  # two query tiles, two ref tiles: cross-tile ties
    (1, 64, 2, 3),      # fewer refs than k: (1e30, 0) slots
    (1, 100, 50, 1),
    (1, 80, 90, 5),
    (1, 300, 4100, 9),  # uniformity_score's k + 1 (the kernel takes k <= 16)
])
def test_knn_plain_matches_pallas(rng, b, n, m, k):
    q, r = tie_inputs(rng, b, n, m)
    d_j, i_j = pallas_knn(jnp.asarray(q), jnp.asarray(r), k=k, interpret=True)
    d_t, i_t = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=0)


def test_knn_plain_chunked_equals_unchunked(rng, monkeypatch):
    from pointcloud_style_transfer_torch.ops.kernels import knn as knn_mod
    q, r = tie_inputs(rng, 1, 400, 300)
    want = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), 3)
    monkeypatch.setattr(knn_mod, "_CHUNK_ELEMS", 7 * 300)  # 7-query chunks
    got = knn_topk_plain(torch.from_numpy(q), torch.from_numpy(r), 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_knn_dispatch(rng):
    q, r = tie_inputs(rng, 1, 50, 40)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = knn_topk_plain(qt, rt, 3)
    for got in (knn(qt, rt, 3, backend="pallas"), knn(qt, rt, 3, backend="jnp"),
                knn_topk(qt, rt, 3), knn(qt.double(), rt, 3)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = knn(qt, rt, 3, backend="grid")  # too few refs: brute force
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the pruned kNN is exact: the same distances; the f32-packed one may
    # swap near-ties but never returns a farther set than 2^-8 relative
    d, i = knn(qt, rt, 3, backend="pallas_pruned")
    assert torch.equal(d, want[0]) and i.dtype == torch.int32
    d, i = knn(qt, rt, 3, backend="pallas_f32packed")
    assert (d >= want[0]).all() and (d <= want[0] * (1 + 2.0 ** -8)).all()
    assert i.dtype == torch.int32 and i.shape == want[1].shape
    with pytest.raises(ValueError):
        knn(qt, rt, 3, backend="nope")


@pytest.mark.parametrize("k,m", [(17, 10), (17, 300), (20, 300)])
def test_knn_past_16_matches_pallas(rng, k, m):
    """Past the register lists' 16 (the CUDA global-list kernel's range;
    k > m leaves (1e30, 0) slots): the wrapper's CPU path against the TPU
    kernel, which takes any k, with XLA's CPU distances so that both
    select from the same bits. (The TPU kernel unrolls a k x k insert
    network: interpret mode compiles k = 20 in ~12 s and k = 33 in over
    200 s, so larger k is held against numpy in
    test_torch_kernel_repairs.py.)"""
    q, r = tie_inputs(rng, 1, 64, m)
    d_j, i_j = pallas_knn(jnp.asarray(q), jnp.asarray(r), k=k, interpret=True)
    with xla_cpu_distances():
        d_t, i_t = knn_topk(torch.from_numpy(q), torch.from_numpy(r), k)
    assert d_t.shape == (1, 64, k) and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy().view(np.int32),
                                  np.asarray(d_j).view(np.int32))
