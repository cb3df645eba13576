"""``examples/probe_sampler_unsafe_torch.py`` against the JAX package's
grid: along the port's trajectory (tiny widths, float32, 1,024 points, 256
coarse, 3 steps at t = 999, 499, 0), drawn from JAX's keys as the JAX
probe draws them (the clouds from keys 1 and 2, the initial noise and the
FPS starts from key 3's splits, the voxel priorities as JAX's
``guided_sample_loop`` draws them from key 3), each step's unsafe rows,
read through ``grid_knn.recording_unsafe``, equal the unsafe rows of
JAX's ``_grid_knn_core`` (interpret mode) on the same step's points, at a
(4, 4, 2) grid with slot window 256, z halo 2 and tq 128, where every step
has some (101-146). The port's plain distances are XLA's CPU form
(``xla_cpu_distances``), so that both grids see the same distances.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import make_schedule

from torch_parity import sampler_draws, xla_cpu_distances

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import probe_sampler_unsafe_torch as probe  # noqa: E402
import profile_common_torch as common  # noqa: E402

J = importlib.import_module("pointcloud_style_transfer_tpu.ops.grid_knn")

N, M, STEPS = 1024, 256, 3
GS, SLOT_CAP, HALO = (4, 4, 2), 256, 2
TINY = dict(total_points=N, global_points=M, feature_dim=32,
            time_embed_dim=16, use_amp=False)


def jax_draws() -> dict:
    k_cond, k_style, k_init, _ = jax.random.split(jax.random.PRNGKey(3), 4)
    cond_priority, step_priorities = sampler_draws(
        jax.random.PRNGKey(3), STEPS, N, N, M)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"source": t(jax.random.normal(jax.random.PRNGKey(1),
                                          (1, N, 3)) * 0.9),
            "condition": t(jax.random.normal(jax.random.PRNGKey(2),
                                             (1, N, 3)) * 0.9),
            "cond_priority": t(cond_priority),
            "fps_starts": t(jax.random.randint(k_style, (2, 1), 0, M)).long(),
            "x_init": t(jax.random.normal(k_init, (1, N, 3))),
            "step_priorities": t(step_priorities)}


def test_unsafe_counts_match_the_jax_grid():
    model = common.random_model("cpu", config=Config(**TINY))
    grid = {"grid_shape": GS, "tq": probe.TQ, "slot_cap": SLOT_CAP,
            "z_halo": HALO}
    states = []
    with xla_cpu_distances():
        counts = probe.trajectory(
            model, make_schedule(model.config), jax_draws(), STEPS, grid,
            on_step=lambda s, q, r: states.append((q.numpy().copy(),
                                                   r.numpy().copy())))
    want = [int(jnp.sum(J._grid_knn_core(jnp.asarray(q), jnp.asarray(r), 3,
                                         GS, probe.TQ, SLOT_CAP, True, True,
                                         HALO)[2]))
            for q, r in states]
    assert counts == want
    assert len(counts) == STEPS and min(counts) > 0


def test_main_prints_every_step(capsys):
    res = probe.main(["2", "4", "4", "2", "2", "256", "--device", "cpu",
                      "--config", *(f"{k}={v}" for k, v in TINY.items())])
    assert res["grid"] == {"grid_shape": GS, "tq": 128, "slot_cap": 256,
                           "z_halo": 2}
    assert res["t"] == [999, 0] and len(res["unsafe"]) == 2
    out = capsys.readouterr().out
    assert "step   1 t=   0 unsafe=" in out and "steps over 4096: 0/2" in out
