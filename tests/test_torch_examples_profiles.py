"""The port's profiling scripts (``examples/*_torch.py``) on the CPU at a
tiny size (1,024 points, 256 coarse, widths 32 / 16, float32; the grid's
entry points at (2, 2, 2) cells, slot window 256 and tq 64, under which
256 coarse points engage it, flat-batched at B = 2): each ``main`` runs
with ``--device cpu``, its readings finite and keyed as the card's run
reads them, and the kernel launches of each path (the wrappers counted on
the CPU here, as they count on the card) what the script's own check
holds on the card; a marginal resolved only past the spread of both its
readings; the production grid whatever the environment sets where the
caller asks for it (``chip_smoke.py``'s grid breakdown).
"""

import functools
import math
import statistics
import sys
from pathlib import Path

import pytest

from pointcloud_style_transfer_torch.ops import grid_knn, sampling
from pointcloud_style_transfer_torch.ops.kernels import LAUNCH_COUNTS

import torch_parity  # noqa: F401  (shares the cores among workers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import profile_batched_sampler_torch as batched_sampler  # noqa: E402
import profile_common_torch as common  # noqa: E402
import profile_interp_stages_torch as interp_stages  # noqa: E402
import profile_sampler_step_batched_torch as step_batched  # noqa: E402
import profile_style_encoder_torch as style_encoder  # noqa: E402
import profile_train_batch_scaling_torch as train_scaling  # noqa: E402
import profile_voxel_batch_torch as voxel_batch  # noqa: E402

TINY = dict(total_points=1024, global_points=256, feature_dim=32,
            time_embed_dim=16, use_amp=False)
GRID = dict(grid_shape=(2, 2, 2), tq=64, slot_cap=256)
CPU = ["--device", "cpu"]
# the scripts that build Config() take it from --config
SMALL = [*CPU, "--config", *(f"{k}={v}" for k, v in TINY.items())]


def counted(name, fn):
    def wrapper(*args, **kwargs):
        LAUNCH_COUNTS[name] += 1
        return fn(*args, **kwargs)
    return wrapper


@pytest.fixture
def tiny(monkeypatch):
    """The small grid bound to the entry points (and to the stage
    script's knobs), the kernel wrappers counted."""
    for name in ("grid_knn_interpolate", "grid_knn_interpolate_layout"):
        monkeypatch.setattr(grid_knn, name, functools.partial(
            getattr(grid_knn, name), **GRID))
    monkeypatch.setenv("PCST_PROF_GRID", "2,2,2")
    monkeypatch.setenv("PCST_PROF_TQ", "64")
    monkeypatch.setenv("PCST_PROF_SLOT_CAP", "256")
    for module, name, kernel in (
            (grid_knn, "grid_interp", "grid_interp"),
            (grid_knn, "knn_topk", "knn_topk"),
            (sampling, "farthest_point_sample_kernel", "fps"),
            (sampling, "ball_query_kernel", "ball_query")):
        monkeypatch.setattr(module, name,
                            counted(kernel, getattr(module, name)))


def finite(x) -> bool:
    return math.isfinite(x)


def test_sampler_step_batched(tiny):
    res = step_batched.main(["1", "2", "--steps", "2", "--reps", "1", *SMALL])
    assert sorted(res["by_batch"]) == [1, 2]
    for B, by_variant in res["by_batch"].items():
        assert list(by_variant) == list(step_batched.VARIANTS)
        for variant, r in by_variant.items():
            assert finite(r["ms_per_step"]) and r["ms_per_step"] > 0
            # one flat pass and one patch launch a step for the batch
            assert r["launches_per_step"] == step_batched.LAUNCHES[variant], \
                (B, variant)
        assert by_variant["noup"]["components"] == [
            "ddim", "denoise", "voxel"]
        # the production upsample at B > 1, the B = 1 tool's split at B = 1
        assert ("upsample" in by_variant["full"]["components"]) == (B > 1)


def test_interp_stages(tiny):
    res = interp_stages.main(["--queries", "900", "--refs", "300",
                              "--chain", "2", "--reps", "1", *CPU])
    stages = res["stages"]
    assert list(stages) == ["build", "values", "layout", "kernel", "margins",
                            "querypass", "querypass_stub", "ladder",
                            "unsort", "interp", "brute"]
    assert all(finite(s["ms"]) for s in stages.values())
    assert stages["kernel"]["launches"] == {"grid_interp": 1}
    assert stages["querypass_stub"]["launches"] == {}
    assert stages["ladder"]["launches"] == {"knn_topk": 1}
    assert stages["interp"]["launches"] == {"grid_interp": 1, "knn_topk": 1}
    assert res["knobs"]["grid_shape"] == (2, 2, 2) and res["full_z"]
    assert set(res["kernel_in_context"]) == {"ms", "noise_ms", "resolved"}


@pytest.mark.parametrize("base,stubbed,resolved", [
    ([2.60, 2.62, 2.61], [2.50, 2.51, 2.49], True),   # 0.10 past 0.02
    ([2.60, 2.62, 2.61], [2.59, 2.51, 2.66], False),  # 0.02 within 0.15
    ([2.60, 2.90, 2.61], [2.50, 2.51, 2.49], False),  # 0.10 within 0.30
])
def test_marginal_is_resolved_only_past_both_spreads(base, stubbed,
                                                     resolved):
    m = common.marginal(base, stubbed)
    assert m["ms"] == pytest.approx(statistics.median(base)
                                    - statistics.median(stubbed))
    assert m["noise_ms"] == pytest.approx(max(max(base) - min(base),
                                              max(stubbed) - min(stubbed)))
    assert m["resolved"] is resolved
    assert ("unresolved" in common.marginal_note(m)) is not resolved


def test_grid_knobs_given_no_environment_are_the_production_grid(tiny):
    assert common.grid_knobs()["grid_shape"] == (2, 2, 2)
    assert common.grid_knobs({}) == {
        "grid_shape": grid_knn.GRID_SHAPE, "tq": 128,
        "slot_cap": grid_knn.SLOT_CAP, "fallback_cap": 4096, "z_halo": 2,
        "xy_halo": 1}


def test_style_encoder(tiny):
    res = style_encoder.main(["--chain", "2", "--reps", "1", *SMALL])
    st = res["stages"]
    assert st["sa1.fps"]["launches"] == {"fps": 1}
    assert st["sa2.ball_query"]["launches"] == {"ball_query": 1}
    for name in ("selection", "encoder", "full"):
        assert st[name]["launches"] == {"fps": 2, "ball_query": 2}
    assert st["sa1.mlp_pool"]["launches"] == {}
    assert set(res["derived"]) == {"head", "mlp_head"}


def test_voxel_batch(tiny):
    res = voxel_batch.main(["1", "2", "--points", "1024", "--global_points",
                            "256", "--chain", "2", "--reps", "1", *CPU])
    assert res["by_batch"][1]["vs_b1"] == 1.0
    assert finite(res["by_batch"][2]["ms_per_cloud"])


def test_train_batch_scaling(tiny):
    res = train_scaling.main(["1", "2", "--reps", "1", *SMALL])
    for B, r in res["by_batch"].items():
        assert finite(r["ms"]) and r["points_per_s"] > 0
        assert set(r["host_ms"]) == {"key", "draws", "call"}
        # the Chamfer term's two k = 1 kNN, the encoder's FPS and ball query
        assert r["launches"]["fps"] == 2 and r["launches"]["ball_query"] == 2


def test_batched_sampler(tiny):
    res = batched_sampler.main(["2", "1", "2", "--reps", "1", *SMALL])
    assert sorted(res["by_mode"]["flat"]) == [1, 2]
    assert sorted(res["by_mode"]["cloud"]) == [2]
    for mode, by_b in res["by_mode"].items():
        for B, r in by_b.items():
            want = batched_sampler.launches_want(mode, B, 2)
            assert r["launches"] == want, (mode, B)
            assert r["points_per_s"] > 0


def test_batched_sampler_cloud_by_cloud_only(tiny, monkeypatch):
    monkeypatch.setenv("PCST_FORCE_LAXMAP", "1")
    res = batched_sampler.main(["2", "2", "--reps", "1", *SMALL])
    assert list(res["by_mode"]) == ["cloud"]
    assert res["by_mode"]["cloud"][2]["launches"]["grid_interp"] == 4
