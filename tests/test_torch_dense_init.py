"""The port's ``Dense`` starts as Flax's ``nn.Dense`` does (the JAX
package's layers): a zero bias and a lecun_normal kernel, a normal of
variance 1 / fan_in truncated at two of its standard deviations. The two
draw from different generators, so their kernels are held on their
statistics: every entry within the truncation bound, and the sample
standard deviations of both within five of their standard errors of
sqrt(1 / fan_in) and of each other."""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import DiffusionNet
from pointcloud_style_transfer_torch.models.networks import Dense

TRUNCATED_STD = 0.87962566103423978  # a unit normal truncated to [-2, 2]


@pytest.mark.parametrize("fan_in,fan_out", [(3, 128), (128, 256),
                                            (512, 256), (1024, 512)])
def test_dense_init_is_flax_dense_init(fan_in, fan_out):
    torch.manual_seed(fan_in)
    port = Dense(fan_in, fan_out)
    params = fnn.Dense(fan_out).init(jax.random.PRNGKey(fan_in),
                                     jnp.zeros((1, fan_in)))["params"]
    w_jax = np.asarray(params["kernel"]).T  # Flax's is [in, out]
    w_port = port.weight.detach().numpy()
    assert w_port.shape == w_jax.shape == (fan_out, fan_in)
    assert not port.bias.detach().any()
    assert not np.asarray(params["bias"]).any()
    std = math.sqrt(1.0 / fan_in)
    bound = 2 * std / TRUNCATED_STD
    err = 5 * std / math.sqrt(2 * w_port.size)  # of a sample std
    for w in (w_port, w_jax):
        assert np.abs(w).max() <= bound * (1 + 1e-6)
        assert abs(w.std() - std) <= err
    assert abs(w_port.std() - w_jax.std()) <= 2 * err


def test_every_dense_of_the_network_starts_as_flax():
    """Every ``Dense`` of ``DiffusionNet`` (the style encoder's per-point
    layers and head, the noise predictor's) has a zero bias and a kernel
    within its truncation bound; the parameter count is unchanged."""
    torch.manual_seed(0)
    net = DiffusionNet(32, 128)
    dense = [m for m in net.modules() if isinstance(m, Dense)]
    assert len(dense) == 31  # 9 + 2 encoder, 3 + 2 + 12 + 3 predictor
    for m in dense:
        bound = 2 * math.sqrt(1.0 / m.in_features) / TRUNCATED_STD
        assert not m.bias.detach().any()
        assert m.weight.detach().abs().max() <= bound * (1 + 1e-6)
    cfg = Config()
    full = DiffusionNet(cfg.feature_dim, cfg.time_embed_dim)
    assert sum(p.numel() for p in full.parameters()) == 2_549_827
