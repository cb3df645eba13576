"""The JAX package's last public helpers in the port, held to the JAX
package on the CPU:

* ``ops/grid_knn.py::_grid_knn_core`` (the structure build and one query
  pass, no fallback) at a (4, 4, 5) grid on clustered clouds with exact
  duplicates, where the pass leaves unsafe rows: in kNN mode the
  distances, ref ids and unsafe flags identical to JAX's in interpret
  mode, in interpolation mode the unsafe flags identical and the values
  within rtol 1e-6, atol 1e-6 * max|v| (the kernels sum in another order);
  the port's plain distances in XLA's CPU form (``xla_cpu_distances``);
* ``PointCloudPreprocessor``'s ``normalize_point_cloud``,
  ``denormalize_point_cloud``, ``consistent_downsample`` and
  ``consistent_upsample``: identical outputs, preprocessors built with the
  same seed (the downsample draws from the preprocessor's generator).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.data import PointCloudPreprocessor
from pointcloud_style_transfer_torch.ops import grid_knn as P
from pointcloud_style_transfer_tpu.data.preprocessing import \
    PointCloudPreprocessor as JaxPreprocessor

from test_torch_grid_knn import assert_values_close, clustered
from torch_parity import xla_cpu_distances

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

GS, TQ, SLOT_CAP = (4, 4, 5), 128, 256


@pytest.mark.parametrize("mode", ["knn", "values"])
def test_grid_knn_core_matches_jax(rng, mode):
    q, r, v = clustered(rng)
    values = v if mode == "values" else None
    want = J._grid_knn_core(jnp.asarray(q), jnp.asarray(r), 3, GS, TQ,
                            SLOT_CAP, True, True, 2,
                            values=None if values is None
                            else jnp.asarray(values))
    with xla_cpu_distances():
        got = P._grid_knn_core(torch.from_numpy(q), torch.from_numpy(r), 3,
                               GS, TQ, SLOT_CAP, 2,
                               values=None if values is None
                               else torch.from_numpy(values))
    unsafe = np.asarray(want[-1])
    assert 0 < unsafe.sum() < len(q)
    np.testing.assert_array_equal(got[-1].numpy(), unsafe)
    if mode == "knn":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32
    else:
        assert_values_close(got[0].numpy(), want[0])


def test_preprocessor_api_methods_match_jax(rng):
    pts = (rng.standard_normal((5000, 3)) * [20, 20, 2]).astype(np.float32)
    port, jax_pre = (PointCloudPreprocessor(4096, 1024, seed=3),
                     JaxPreprocessor(4096, 1024, seed=3))
    norm, params = port.normalize_point_cloud(pts, 1.5)
    norm_j, params_j = jax_pre.normalize_point_cloud(pts, 1.5)
    np.testing.assert_array_equal(norm, norm_j)
    assert params["scale"] == params_j["scale"]
    np.testing.assert_array_equal(params["center"], params_j["center"])
    np.testing.assert_array_equal(port.denormalize_point_cloud(norm, params),
                                  jax_pre.denormalize_point_cloud(norm_j,
                                                                  params_j))
    for _ in range(2):  # the second call draws on from the same generator
        down, idx = port.consistent_downsample(norm, 1000)
        down_j, idx_j = jax_pre.consistent_downsample(norm_j, 1000)
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(down, down_j)
    coarse = down + rng.normal(0, 0.01, down.shape).astype(np.float32)
    np.testing.assert_array_equal(
        port.consistent_upsample(coarse, norm, idx),
        jax_pre.consistent_upsample(coarse, norm_j, idx_j))
