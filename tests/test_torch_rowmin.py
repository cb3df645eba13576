"""The row minimum and the Chamfer's custom gradient vs the TPU kernels
(``pallas_min_sq_dist`` in interpret mode).

Values: identical to the TPU kernel once the port's plain version computes
distances in XLA's CPU FMA form (``xla_cpu_distances``); with its own
one-rounding-per-op form within 1e-6 relative. Gradients of ``MinSqDist``
(the k=1 kNN forward, the analytic backward) within 1e-6 of ``jax.grad``
through the TPU kernels' custom VJP, ties going to the lowest ref index on
both sides. NaN propagates as ``jnp.minimum``/``jnp.maximum`` propagate it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import (chamfer_distance,
                                                 chamfer_distance_l2,
                                                 min_sq_dist, square_distance)
from pointcloud_style_transfer_torch.ops import distance as port_distance
from pointcloud_style_transfer_torch.ops.kernels import (rowmin_kernel,
                                                         rowmin_plain)
from pointcloud_style_transfer_torch.ops.kernels import rowmin as rowmin_mod
from pointcloud_style_transfer_tpu.ops import distance as jax_distance
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import \
    pallas_min_sq_dist

from torch_parity import pallas_vjp_min_sq_dist, xla_cpu_distances


def clouds(rng, b, n, m):
    """Refs with exact duplicates and queries sitting on refs (zero-distance
    ties between duplicate refs)."""
    r = rng.standard_normal((b, m, 3)).astype(np.float32)
    q = rng.standard_normal((b, n, 3)).astype(np.float32)
    n_dup = max(1, m // 5)
    r[:, rng.choice(m, n_dup, replace=False)] = r[:, rng.choice(m, n_dup)]
    q[:, : n // 4] = r[:, rng.choice(m, n // 4)]
    return q, r


@pytest.mark.parametrize("b,n,m", [
    (1, 1030, 4100),  # neither N a multiple of 1024 nor M of 4096
    (2, 300, 200),
    (1, 64, 1),
])
def test_rowmin_identical_to_pallas(rng, b, n, m):
    q, r = clouds(rng, b, n, m)
    want = np.asarray(pallas_min_sq_dist(jnp.asarray(q), jnp.asarray(r),
                                         True))
    with xla_cpu_distances():
        got = rowmin_plain(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, want)
    own = rowmin_kernel(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(own, want, rtol=1e-6, atol=0)
    assert (own >= 0).all() and (own[:, : n // 4] == 0).all()


def test_rowmin_plain_chunked_equals_unchunked(rng, monkeypatch):
    q, r = clouds(rng, 2, 200, 150)
    want = rowmin_plain(torch.from_numpy(q), torch.from_numpy(r))
    monkeypatch.setattr(rowmin_mod, "_CHUNK_ELEMS", 7 * 150)
    got = rowmin_plain(torch.from_numpy(q), torch.from_numpy(r))
    assert torch.equal(got, want)


def test_rowmin_propagates_nan(rng):
    q, r = clouds(rng, 2, 40, 30)
    q[0, 3] = np.nan  # one NaN query: its row only
    r[1, 7, 2] = np.nan  # one NaN ref: every row of its cloud
    want = np.asarray(pallas_min_sq_dist(jnp.asarray(q), jnp.asarray(r),
                                         True))
    got = rowmin_plain(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    assert np.isnan(want[0, 3]) and np.isnan(want[1]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=0)


@pytest.mark.parametrize("b,n,m", [(2, 300, 200), (1, 70, 500)])
def test_min_sq_dist_grad_matches_pallas_vjp(rng, b, n, m):
    q, r = clouds(rng, b, n, m)
    w = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)

    def loss(qq, rr):
        return jnp.sum(jnp.asarray(w) * pallas_min_sq_dist(qq, rr, True))
    val_j, (dq_j, dr_j) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(r))

    qt = torch.from_numpy(q).requires_grad_()
    rt = torch.from_numpy(r).requires_grad_()
    with xla_cpu_distances():
        val_t = torch.sum(torch.from_numpy(w) * min_sq_dist(qt, rt))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-6)
    for got, want in ((qt.grad, dq_j), (rt.grad, dr_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert (np.asarray(dr_j) != 0).any()


def test_min_sq_dist_paths(rng, monkeypatch):
    """Under grad the forward is the k=1 kNN (its argmin is needed), without
    a gradient to compute it is the row minimum; ``"jnp"`` is the plain row
    minimum, differentiated by autograd."""
    q, r = clouds(rng, 1, 50, 40)
    calls = []
    for name in ("knn_topk", "rowmin_kernel"):
        fn = getattr(port_distance, name)
        monkeypatch.setattr(port_distance, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    want = rowmin_plain(qt, rt)
    assert torch.equal(min_sq_dist(qt, rt), want) and calls == ["rowmin_kernel"]
    qg = qt.clone().requires_grad_()
    assert torch.equal(min_sq_dist(qg, rt), want)
    assert calls == ["rowmin_kernel", "knn_topk"]
    with torch.no_grad():
        min_sq_dist(qg, rt)
    assert calls[-1] == "rowmin_kernel"
    d_jnp = min_sq_dist(qg, rt, backend="jnp")
    assert torch.equal(d_jnp, want) and d_jnp.requires_grad
    with pytest.raises(ValueError):
        min_sq_dist(qt, rt, backend="nope")


def test_chamfer_and_square_distance_match_jax(rng, monkeypatch):
    pallas_vjp_min_sq_dist(monkeypatch)
    a, b = clouds(rng, 2, 90, 120)
    b = b[:, :90]
    want = np.asarray(jax_distance.chamfer_distance(jnp.asarray(a),
                                                    jnp.asarray(b)))
    want_l2 = np.asarray(jax_distance.chamfer_distance_l2(jnp.asarray(a),
                                                          jnp.asarray(b)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(chamfer_distance(at, bt).numpy(), want,
                               rtol=1e-6)
    np.testing.assert_allclose(chamfer_distance_l2(at, bt).numpy(), want_l2,
                               rtol=1e-6)
    sq = np.asarray(jax_distance.square_distance(jnp.asarray(a),
                                                 jnp.asarray(b)))
    np.testing.assert_allclose(square_distance(at, bt).numpy(), sq,
                               rtol=1e-5, atol=1e-5)
