"""k past the register lists (9 and 17): the port's plain versions against
the JAX package, whose kernels take any k.

The CUDA kernels keep their lists in registers up to k = 16 (the grid's
since its first port up to 8) and in global memory above; their plain
versions, which the CPU runs and the card tests hold the kernels to, must
equal the JAX package at those k too: the packed-key kernels' raw keys,
indices and recomputed distances (``_knn_packed_single``,
``_knn_f32packed_single`` in interpret mode), the pruned kNN
(``pallas_knn_pruned`` in interpret mode), and the kd-grid's kNN and
interpolation at ``grid_shape=(2, 2, 2)``. The port's plain distances take
XLA's CPU FMA form (``xla_cpu_distances``) where bits are compared.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_torch.ops import knn_pruned
from pointcloud_style_transfer_torch.ops.kernels import (
    knn_f32packed, knn_f32packed_keys, knn_intpacked, knn_intpacked_keys)
from pointcloud_style_transfer_torch.ops.kernels import knn_packed as kp
from pointcloud_style_transfer_tpu.ops.pallas import distance_topk as J
from pointcloud_style_transfer_tpu.ops.pallas import pruned_knn as JP

from test_torch_grid_knn import assert_values_close, clustered
from test_torch_knn import tie_inputs
from test_torch_knn_packed import jax_keys_and_result
from torch_parity import xla_cpu_distances

# the module (the package's ``grid_knn`` attribute is its function)
JG = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")
KS = (9, 17)
GRID = dict(grid_shape=(2, 2, 2))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["f32packed", "intpacked"])
def test_packed_keys_match_pallas(rng, monkeypatch, name, k):
    """Raw keys, decoded indices and recomputed distances, with refs that
    fill their tile and a ragged last tile (padding refs)."""
    jfn, keys_fn, fn = {
        "f32packed": (J._knn_f32packed_single, knn_f32packed_keys,
                      knn_f32packed),
        "intpacked": (J._knn_packed_single, knn_intpacked_keys,
                      knn_intpacked)}[name]
    n, m = 200, 700
    q, r = tie_inputs(rng, 1, n, m)
    keys_j, d_j, i_j = jax_keys_and_result(monkeypatch, jfn, q[0], r[0], k,
                                           tq=128, tr=512)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    with xla_cpu_distances(jit_recompute=False):  # JAX ran eagerly
        keys_t = keys_fn(qt, rt, k, kp.padded_refs(m, 512))
        d_t, i_t = fn(qt, rt, k, tr=512)
    np.testing.assert_array_equal(keys_t[0].numpy().view(np.int32),
                                  keys_j[:n].view(np.int32))
    np.testing.assert_array_equal(i_t[0].numpy(), i_j)
    np.testing.assert_array_equal(d_t[0].numpy(), d_j)


@pytest.mark.parametrize("k", KS)
def test_pruned_knn_matches_pallas(rng, k):
    """The whole pruned kNN at its default tiles, batched, with duplicate
    refs, lattice points and queries on refs."""
    q, r = tie_inputs(rng, 2, 600, 700)
    d_j, i_j = JP.pallas_knn_pruned(jnp.asarray(q), jnp.asarray(r), k,
                                    interpret=True)
    with xla_cpu_distances():
        d_t, i_t = knn_pruned(torch.from_numpy(q), torch.from_numpy(r), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("k", KS)
def test_grid_knn_matches_jax(rng, k):
    q, r, _ = clustered(rng, m=600, n_cluster=500, n_bg=524)
    d_j, i_j = JG.grid_knn(jnp.asarray(q)[None], jnp.asarray(r)[None], k=k,
                           interpret=True, **GRID)
    with xla_cpu_distances():
        d_p, i_p = P.grid_knn(torch.from_numpy(q)[None],
                              torch.from_numpy(r)[None], k=k, **GRID)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("k", KS)
def test_grid_interpolate_matches_jax(rng, k):
    q, r, v = clustered(rng, m=600, n_cluster=500, n_bg=524)
    want = JG.grid_knn_interpolate(jnp.asarray(q)[None], jnp.asarray(r)[None],
                                   jnp.asarray(v)[None], k=k, interpret=True,
                                   **GRID)
    with xla_cpu_distances():
        got = P.grid_knn_interpolate(torch.from_numpy(q)[None],
                                     torch.from_numpy(r)[None],
                                     torch.from_numpy(v)[None], k=k, **GRID)
    assert_values_close(got.numpy(), np.asarray(want))
