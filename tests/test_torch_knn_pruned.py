"""The Morton-pruned exact kNN: the port (``ops/pruned_knn.py`` over the
pass kernel's plain version) vs the JAX package (``pruned_knn.py``, its
kernel in interpret mode), step by step with small tiles: Morton codes and
permutations, the window and prune masks, both passes' running state and the
final (d, i). The port's plain distances take XLA's CPU form
(``xla_cpu_distances``), so everything is compared for identity. Clouds:
gaussian, and clustered with exact duplicates and lattice points (equal
distances inside and across tiles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import knn, knn_pruned
from pointcloud_style_transfer_torch.ops import pruned_knn as P
from pointcloud_style_transfer_torch.ops.kernels import (knn_pruned_pass,
                                                         knn_topk)
from pointcloud_style_transfer_tpu.ops.pallas import pruned_knn as J

from test_torch_knn import tie_inputs
from torch_parity import xla_cpu_distances

TQ, TR, WINDOW = 128, 256, 2


def gaussian(rng, n, m):
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((m, 3)).astype(np.float32))


def clustered_ties(rng, n, m):
    """Tight clusters far apart (so that tiles are pruned) with duplicate
    refs, queries on refs and lattice blocks."""
    q, r = tie_inputs(rng, 1, n, m)
    q, r = q[0] * 0.05, r[0] * 0.05
    centers = rng.uniform(-20, 20, (8, 3)).astype(np.float32)
    r += centers[rng.integers(0, 8, m)]
    q += centers[rng.integers(0, 8, n)]
    q[: n // 4] = r[rng.choice(m, n // 4)]
    return q, r


CLOUDS = {"gaussian": gaussian, "clustered": clustered_ties}


def jax_steps(q, r, k):
    """``_pruned_knn_single`` op for op, keeping every intermediate."""
    q, r = jnp.asarray(q), jnp.asarray(r)
    N, M = q.shape[0], r.shape[0]
    lo = jnp.minimum(q.min(axis=0), r.min(axis=0))
    hi = jnp.maximum(q.max(axis=0), r.max(axis=0))
    inv = 1.0 / jnp.maximum(hi - lo, 1e-6)
    cq, cr = J.morton_codes(q, lo, inv), J.morton_codes(r, lo, inv)
    q_perm, r_perm = jnp.argsort(cq), jnp.argsort(cr)
    qs, rs = q[q_perm], r[r_perm]
    n_pad, m_pad = (-N) % TQ, (-M) % TR
    if n_pad:
        qs = jnp.concatenate([qs, jnp.tile(qs[-1:], (n_pad, 1))])
    if m_pad:
        rs = jnp.concatenate([rs, jnp.full((m_pad, 3), 1e15, jnp.float32)])
    nq, nr = qs.shape[0] // TQ, rs.shape[0] // TR
    qi = jnp.arange(nq)
    center = jnp.clip(((qi + 0.5) * (nr / nq)).astype(jnp.int32)
                      - WINDOW // 2, 0, max(nr - WINDOW, 0))
    in_window = (jnp.arange(nr)[None, :] >= center[:, None]) & \
        (jnp.arange(nr)[None, :] < center[:, None] + WINDOW)
    d0 = jnp.full((qs.shape[0], k), 1e30, jnp.float32)
    i0 = jnp.zeros((qs.shape[0], k), jnp.int32)
    skip1 = (~in_window).astype(jnp.int32)
    d1, i1 = J._run_pass(qs, rs.T, skip1, d0, i0, k, TQ, TR, True)
    ub = d1[:, k - 1].reshape(nq, TQ).max(axis=1)
    lb = J._bbox_sq_dist(*J._tile_bboxes(qs, TQ), *J._tile_bboxes(rs, TR))
    skip2 = ((lb > ub[:, None]) | in_window).astype(jnp.int32)
    d2, i2 = J._run_pass(qs, rs.T, skip2, d1, i1, k, TQ, TR, True)
    return {k_: np.asarray(v) for k_, v in dict(
        cq=cq, cr=cr, q_perm=q_perm, r_perm=r_perm, qs=qs, rs=rs,
        in_window=in_window, skip1=skip1, d1=d1, i1=i1, skip2=skip2, d2=d2,
        i2=i2).items()}


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_pruned_steps_match_jax(rng, cloud, k):
    n, m = 1000, 900  # ragged: 8 query tiles, 4 ref tiles, both padded
    q, r = CLOUDS[cloud](rng, n, m)
    want = jax_steps(q, r, k)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)

    lo = torch.minimum(qt.amin(0), rt.amin(0))
    hi = torch.maximum(qt.amax(0), rt.amax(0))
    inv = 1.0 / (hi - lo).clamp(min=1e-6)
    np.testing.assert_array_equal(P.morton_codes(qt, lo, inv).numpy(),
                                  want["cq"])
    np.testing.assert_array_equal(P.morton_codes(rt, lo, inv).numpy(),
                                  want["cr"])
    qs, rs, q_perm, r_perm = P.sort_and_pad(qt, rt, TQ, TR)
    np.testing.assert_array_equal(q_perm.numpy(), want["q_perm"])
    np.testing.assert_array_equal(r_perm.numpy(), want["r_perm"])
    np.testing.assert_array_equal(qs.numpy(), want["qs"])
    np.testing.assert_array_equal(rs.numpy(), want["rs"])
    nq, nr = qs.shape[0] // TQ, rs.shape[0] // TR
    in_window = P.window_mask(nq, nr, WINDOW, qt.device)
    np.testing.assert_array_equal(in_window.numpy(), want["in_window"])

    with xla_cpu_distances():
        d0 = qs.new_full((qs.shape[0], k), 1e30)
        i0 = torch.zeros((qs.shape[0], k), dtype=torch.int32)
        d1, i1 = knn_pruned_pass(qs, rs, (~in_window).int(), d0, i0, k, TQ, TR)
        np.testing.assert_array_equal(d1.numpy(), want["d1"])
        np.testing.assert_array_equal(i1.numpy(), want["i1"])
        skip2 = (P.prune_mask(qs, rs, d1, k, TQ, TR) | in_window).int()
        np.testing.assert_array_equal(skip2.numpy(), want["skip2"])
        d2, i2 = knn_pruned_pass(qs, rs, skip2, d1, i1, k, TQ, TR)
    np.testing.assert_array_equal(d2.numpy(), want["d2"])
    np.testing.assert_array_equal(i2.numpy(), want["i2"])
    if cloud == "clustered":  # the prune must do something here
        pruned = (want["skip2"] != 0) & ~want["in_window"]
        assert pruned.sum() > 0


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_pruned_knn_matches_jax(rng, cloud):
    n, m, k = 700, 600, 3
    q, r = CLOUDS[cloud](rng, n, m)
    d_j, i_j = J._pruned_knn_single(jnp.asarray(q), jnp.asarray(r), k, tq=TQ,
                                    tr=TR, interpret=True)
    with xla_cpu_distances():
        d_t, i_t = P._pruned_knn_single(torch.from_numpy(q),
                                        torch.from_numpy(r), k, tq=TQ, tr=TR)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_pruned_default_tiles_equal_brute_force(rng):
    """At the default tiles (512 x 2,048), batched, through ``knn``: the
    distances are the brute-force kernel's bit for bit and the ids are the
    same wherever the k + 1 nearest distances are distinct; also against the
    JAX entry point."""
    q, r = tie_inputs(rng, 2, 1100, 1000)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    d_p, i_p = knn(qt, rt, 3, backend="pallas_pruned")
    d_b, i_b = knn_topk(qt, rt, 3)
    assert torch.equal(d_p, d_b)
    d4 = knn_topk(qt, rt, 4)[0]
    distinct = (d4[..., 1:] != d4[..., :-1]).all(-1)
    assert distinct.sum() > 500
    assert torch.equal(i_p[distinct], i_b[distinct])
    d_j, i_j = J.pallas_knn_pruned(jnp.asarray(q), jnp.asarray(r), 3,
                                   interpret=True)
    with xla_cpu_distances():
        d_x, i_x = knn_pruned(qt, rt, 3)
    np.testing.assert_array_equal(i_x.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_x.numpy(), np.asarray(d_j))


def test_pass_keeps_earlier_entries_on_ties_and_drops_nan(rng):
    """An entry of the initial state stays ahead of an equidistant candidate,
    equidistant candidates enter by sorted position, a skipped tile gives
    nothing, and a NaN distance is never taken."""
    q = torch.zeros((2, 3))
    r = torch.zeros((8, 3))
    r[:, 0] = torch.tensor([1., 2., 1., 3., 1., float("nan"), 0.5, 1.])
    d0 = torch.tensor([[1.0, 1e30], [1e30, 1e30]])
    i0 = torch.tensor([[7, 0], [0, 0]], dtype=torch.int32)
    skip = torch.tensor([[0, 0, 1, 0]], dtype=torch.int32)  # tile 2 = refs 4, 5
    d, i = knn_pruned_pass(q, r, skip, d0, i0, 2, 2, 2)
    assert d.tolist() == [[0.25, 1.0], [0.25, 1.0]]
    assert i.tolist() == [[6, 7], [6, 0]]
    d, i = knn_pruned_pass(q, r, torch.zeros_like(skip), d0, i0, 2, 2, 2)
    assert i.tolist() == [[6, 7], [6, 0]] and not torch.isnan(d).any()
    qn = q.clone()
    qn[1, 1] = float("nan")
    d, i = knn_pruned_pass(qn, r, skip, d0, i0, 2, 2, 2)
    assert torch.equal(d[1], d0[1]) and i[1].tolist() == [0, 0]
