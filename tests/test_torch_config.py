"""Port config vs the JAX package's config: same fields, defaults, JSON."""

import dataclasses

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_tpu.config import Config as JaxConfig


def test_fields_and_defaults_match_jax():
    assert ([f.name for f in dataclasses.fields(Config)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert Config().to_dict() == JaxConfig().to_dict()


def test_json_round_trip_and_cross_read():
    c = Config(total_points=1234, global_points=321, knn_backend="jnp",
               use_amp=False, mesh_shape={"data": 2})
    assert Config.from_json(c.to_json()) == c
    # each package reads the other's JSON
    assert JaxConfig.from_json(c.to_json()).to_dict() == c.to_dict()
    assert Config.from_json(JaxConfig(seed=7).to_json()) == Config(seed=7)
    # unknown keys are ignored, as in the JAX package
    assert Config.from_dict({**c.to_dict(), "not_a_field": 1}) == c
    assert c.replace(seed=3).seed == 3 and c.seed == 42
