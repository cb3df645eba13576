"""The evaluation metrics (``evaluation/metrics.py``) against the JAX
package's.

The JAX metrics run the TPU kernels in interpret mode (row minimum through
``pallas_min_sq_dist``, uniformity's kNN through ``pallas_knn``), called
unjitted so that the patches take effect whatever an earlier test compiled;
the port's plain kernels compute distances in XLA's CPU FMA form. So the
row minima are identical, and every metric agrees within 1e-6 relative
(the means are summed in another order). The Sinkhorn EMD is plain tensor
code on both sides: within 2e-4 relative (measured 5.5e-5: the cost enters
as C / epsilon = 20 C through 50 log-sum-exp iterations). The greedy EMD
is the same numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.evaluation import metrics
from pointcloud_style_transfer_tpu.evaluation import metrics as jax_metrics
from pointcloud_style_transfer_tpu.ops.pallas.distance_topk import pallas_knn

from torch_parity import pallas_vjp_min_sq_dist, xla_cpu_distances

RTOL = 1e-6


def unjit(fn):
    return getattr(fn, "__wrapped__", fn)


@pytest.fixture
def jax_kernels(monkeypatch):
    pallas_vjp_min_sq_dist(monkeypatch)
    monkeypatch.setattr(
        jax_metrics, "knn",
        lambda q, r, k, chunk_size=2048: pallas_knn(q, r, k, interpret=True))
    with xla_cpu_distances():
        yield


def clouds(rng, b=2, n=300, m=260):
    a = (rng.standard_normal((b, n, 3)) * 0.5).astype(np.float32)
    t = (rng.standard_normal((b, m, 3)) * 0.5).astype(np.float32)
    t[:, :40] = a[:, :40]  # exact matches
    return a, t


def both(a, t):
    return (jnp.asarray(a), jnp.asarray(t)), (torch.from_numpy(a),
                                              torch.from_numpy(t))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_chamfer(rng, jax_kernels, bidirectional):
    (ja, jt), (ta, tt) = both(*clouds(rng))
    want = jax_metrics.chamfer_distance(ja, jt, bidirectional=bidirectional)
    got = metrics.chamfer_distance(ta, tt, bidirectional=bidirectional)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_hausdorff_and_coverage(rng, jax_kernels):
    (ja, jt), (ta, tt) = both(*clouds(rng))
    np.testing.assert_allclose(
        metrics.hausdorff_distance(ta, tt).numpy(),
        np.asarray(unjit(jax_metrics.hausdorff_distance)(ja, jt)), rtol=RTOL)
    for thr in (0.01, 0.1, 0.3):
        assert metrics.coverage_score(ta, tt, thr).item() == pytest.approx(
            float(unjit(jax_metrics.coverage_score)(ja, jt, thr)), rel=RTOL)


@pytest.mark.parametrize("threshold", [0.05, 0.2])
def test_precision_recall_f1(rng, jax_kernels, threshold):
    (ja, jt), (ta, tt) = both(*clouds(rng))
    want = unjit(jax_metrics.precision_recall_f1)(ja, jt, threshold)
    got = metrics.precision_recall_f1(ta, tt, threshold)
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(float(w), rel=RTOL)
    assert 0 < got[2].item() < 1


@pytest.mark.parametrize("k", [8, 4])
def test_uniformity(rng, jax_kernels, k):
    """k = 8 asks the kNN for 9 neighbours (the self-neighbour is dropped):
    above the kNN kernel's former cap of 8."""
    a, _ = clouds(rng)
    want = float(unjit(jax_metrics.uniformity_score)(jnp.asarray(a), k))
    got = metrics.uniformity_score(torch.from_numpy(a), k).item()
    assert got == pytest.approx(want, rel=RTOL)


def test_fidelity(rng):
    (ja, jt), (ta, tt) = both(*clouds(rng, n=260))
    assert metrics.fidelity_score(ta, tt) == pytest.approx(
        jax_metrics.fidelity_score(ja, jt), rel=RTOL)
    w = rng.standard_normal((30, 16)).astype(np.float32)
    got = metrics.fidelity_score(
        ta, tt, lambda x: x.reshape(x.shape[0], -1)[:, :30]
        @ torch.from_numpy(w))
    want = jax_metrics.fidelity_score(
        ja, jt, lambda x: x.reshape(x.shape[0], -1)[:, :30] @ jnp.asarray(w))
    assert got == pytest.approx(want, rel=RTOL)


def test_emd_greedy_identical(rng):
    a, t = clouds(rng, n=120, m=120)
    np.testing.assert_array_equal(metrics.earth_mover_distance_greedy(a, t),
                                  jax_metrics.earth_mover_distance_greedy(a, t))
    with pytest.raises(ValueError):
        metrics.earth_mover_distance_greedy(a, t[:, :50])


def test_emd_sinkhorn(rng):
    a, t = clouds(rng, n=200, m=150)
    want = np.asarray(jax_metrics.earth_mover_distance(
        jnp.asarray(a), jnp.asarray(t), epsilon=0.05, num_iters=50))
    got = metrics.earth_mover_distance(torch.from_numpy(a),
                                       torch.from_numpy(t), epsilon=0.05,
                                       num_iters=50).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_emd_subsampling_with_given_permutations(rng):
    a, _ = clouds(rng, b=1, n=900)
    b = a + np.array([0.5, 0, 0], np.float32)
    perms = (torch.from_numpy(rng.permutation(900)),
             torch.from_numpy(rng.permutation(900)))
    v = metrics.earth_mover_distance(torch.from_numpy(a), torch.from_numpy(b),
                                     max_points=256, perms=perms).item()
    full = metrics._sinkhorn_emd(
        torch.from_numpy(a)[:, perms[0][:256]],
        torch.from_numpy(b)[:, perms[1][:256]])
    assert v == full.item() and 0.3 < v < 0.8


class _OnePointsRank:
    """A mesh whose ``points`` axis has one rank (what
    ``parallel.mesh.axis_size`` reads of a ``DeviceMesh``)."""
    mesh_dim_names = ("points",)

    def size(self, dim=None):
        return 1


def test_ring_chamfer_not_ported(rng):
    """A mesh without a second ``points`` rank takes the dense path, as in
    the JAX package (the ring itself: tests/test_torch_ring.py)."""
    _, (ta, tt) = both(*clouds(rng))
    for bidirectional in (True, False):
        got = metrics.chamfer_distance(ta, tt, bidirectional,
                                       mesh=_OnePointsRank())
        assert torch.equal(got, metrics.chamfer_distance(ta, tt,
                                                         bidirectional))
