"""Networks with weights converted from Flax vs the JAX package.

float32: NoisePredictor within 2e-4 and StyleEncoder within 5e-4 (the bars
of the JAX package's own parity tests against its reference). bf16 compute:
the tolerances below were measured (port vs JAX, both bf16) and are about
twice the largest difference seen, which comes from where each framework
rounds to bf16. FPS starts are pinned to 0 on both sides, and the JAX
encoder runs the TPU kernels in interpret mode so both sides select the
same points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.convert import (flax_to_torch,
                                                     noise_predictor_state,
                                                     style_encoder_state)
from pointcloud_style_transfer_torch.models import (DiffusionNet,
                                                    NoisePredictor,
                                                    StyleEncoder)
from pointcloud_style_transfer_tpu.config import Config as JaxConfig
from pointcloud_style_transfer_tpu.models import PointCloudDiffusionModel
from pointcloud_style_transfer_tpu.models import networks as jnet

from torch_parity import perturbed, pin_jax_encoder

# measured max |port - JAX| in bf16: noise predictor 0.0703 on outputs of
# magnitude ~3 (about 4 bf16 ulps after 20 layers), style encoder 0.0029
NP_BF16_ATOL = 0.15
SE_BF16_ATOL = 6e-3


def noise_inputs(rng):
    x = rng.standard_normal((2, 100, 3)).astype(np.float32)
    t = np.array([5, 500])
    style = rng.standard_normal((2, 256)).astype(np.float32)
    return x, t, style


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-4),
                                        (jnp.bfloat16, NP_BF16_ATOL)])
def test_noise_predictor_matches_jax(rng, key, dtype, atol):
    x, t, style = noise_inputs(rng)
    ref_mod = jnet.NoisePredictor(feature_dim=256, time_embed_dim=128,
                                  dtype=dtype)
    params = ref_mod.init({"params": key}, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(style))["params"]
    params = perturbed(params, rng)
    want = np.asarray(ref_mod.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(style), False),
                      np.float32)
    ours = NoisePredictor(256, 128, compute_dtype=(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)).eval()
    ours.load_state_dict(noise_predictor_state(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(style)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 5e-4),
                                        (jnp.bfloat16, SE_BF16_ATOL)])
def test_style_encoder_matches_jax(rng, key, monkeypatch, dtype, atol):
    pin_jax_encoder(monkeypatch)
    pts = rng.standard_normal((2, 600, 3)).astype(np.float32)
    ref_mod = jnet.StyleEncoder(feature_dim=256, dtype=dtype)
    variables = ref_mod.init({"params": key, "sampling": key},
                             jnp.asarray(pts), False)
    params = perturbed(variables["params"], rng)
    stats = perturbed(variables["batch_stats"], rng)
    want = np.asarray(ref_mod.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(pts), False,
                                    rngs={"sampling": key}), np.float32)
    ours = StyleEncoder(256, compute_dtype=(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)).eval()
    ours.load_state_dict(style_encoder_state(params, stats))
    with torch.no_grad():
        got = ours(torch.from_numpy(pts),
                   fps_starts=torch.zeros((2, 2), dtype=torch.int64)
                   ).float().numpy()
    assert np.abs(want).max() > 0.1  # a live (not all-ReLU-zero) output
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_full_width_param_count_and_conversion(key):
    net = DiffusionNet()  # Config() widths: feature 256, time embed 128
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(net.style_encoder) == 675_136
    assert count(net.noise_predictor) == 1_874_691
    assert count(net) == 2_549_827
    # every Flax variable maps onto a port name and back (strict load)
    variables = PointCloudDiffusionModel(JaxConfig()).init(
        key, example_points=256)
    sd = flax_to_torch(jax.device_get(variables))
    net.load_state_dict(sd)
    n_flax = sum(np.asarray(x).size for x in
                 jax.tree_util.tree_leaves(variables["params"]))
    assert n_flax == 2_549_827
