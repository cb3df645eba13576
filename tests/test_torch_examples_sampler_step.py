"""``examples/profile_sampler_step_torch.py`` on the CPU at a tiny size
(1,024 points, 256 coarse, widths 32 / 16, float32, the grid at (2, 2, 2)
cells with slot window 256 and tq 64 through the script's environment
knobs, under which 256 coarse points engage it):

* ``--config`` sets the run's Config fields;
* the ``full`` body gives exactly what ``samplers._guided_body`` gives over
  10 steps from the same x, style and step priorities (the script's own
  check, which raises on a difference);
* each variant: finite output of [1, N, 3], the same at every call, the
  components it runs, and the kernel launches it makes a step (the
  wrappers the grid calls counted on the CPU here: ``grid_interp`` and the
  ladder's ``knn_topk``), against ``LAUNCHES``;
* where a variant's marginal went on the device, from two profiles;
* two variants in a row through the capture runner (CPU stand-ins,
  ``torch_dist.fake_runner``) each capture and replay their own body; the
  control shows why the key must hold the variant: a second body under
  the first's key replays the first's graph.
"""

import collections
import functools
import sys
from pathlib import Path

import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import make_schedule
from pointcloud_style_transfer_torch.ops import grid_knn
from pointcloud_style_transfer_torch.ops.kernels import LAUNCH_COUNTS

from torch_dist import fake_runner
import torch_parity  # noqa: F401  (shares the cores among workers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import profile_common_torch as common  # noqa: E402
import profile_sampler_step_torch as step_tool  # noqa: E402

N, M = 1024, 256
TINY = dict(total_points=N, global_points=M, feature_dim=32,
            time_embed_dim=16, use_amp=False)
ARGS = ["--device", "cpu", "--config",
        *(f"{k}={v}" for k, v in TINY.items())]
KNOBS = {"PCST_PROF_GRID": "2,2,2", "PCST_PROF_TQ": "64",
         "PCST_PROF_SLOT_CAP": "256"}


def counted(name, fn):
    """``fn`` adding one to ``LAUNCH_COUNTS[name]`` a call, as the
    wrappers do where they launch their kernel on the card."""
    def wrapper(*args, **kwargs):
        LAUNCH_COUNTS[name] += 1
        return fn(*args, **kwargs)
    return wrapper


@pytest.fixture
def tiny(monkeypatch):
    """The tiny grid, the grid's kernel wrappers counted."""
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    for name in ("grid_interp", "knn_topk"):
        monkeypatch.setattr(grid_knn, name,
                            counted(name, getattr(grid_knn, name)))


def test_full_body_equals_guided_body(tiny):
    res = step_tool.main(["full", "--steps", "10", "--reps", "1", *ARGS])
    assert res["full_equals_guided_body"] is True
    assert res["knobs"]["grid_shape"] == (2, 2, 2)
    full = res["variants"]["full"]
    assert full["launches_per_step"] == {"grid_interp": 1, "knn_topk": 1}


@pytest.mark.parametrize("variant", step_tool.VARIANTS)
def test_variant_output_and_launches(tiny, variant):
    res = step_tool.main([variant, "--steps", "2", "--reps", "1", *ARGS])
    got = res["variants"][variant]
    out = res["outputs"][variant]
    assert out.shape == (1, N, 3) and torch.isfinite(out).all()
    assert got["launches_per_step"] == step_tool.LAUNCHES[variant]
    assert got["components"] == sorted(step_tool.COMPONENTS[variant])
    assert got["ms_per_step"] > 0
    if variant != "full":  # timed in turns with a full graph beside it
        m = got["marginal"]
        assert m["noise_ms"] >= 0 and isinstance(m["resolved"], bool)


def run_pair(variants, steps=2, reps=2):
    model = common.random_model("cpu", config=Config(**TINY))
    schedule = make_schedule(model.config)
    gen = torch.Generator().manual_seed(7)
    inputs = step_tool.sampler_inputs(model, 1, steps, gen)
    knobs = common.grid_knobs()
    bound = functools.partial(grid_knn.grid_knn_interpolate_layout, **knobs)
    with common.patched(grid_knn, "grid_knn_interpolate_layout", bound):
        res = step_tool.run_variants(model, variants, steps, reps, inputs,
                                     schedule, knobs,
                                     model.config.guidance_scale, "test")
        eager = {v: step_tool.make_body(
            model, v, steps, model.config.guidance_scale, knobs,
            collections.Counter())(
                {"x": inputs["x_init"], "source": inputs["source"],
                 "style_in": inputs["style_in"],
                 "step_priorities": inputs["step_priorities"],
                 **step_tool.samplers._schedule_inputs(schedule)})
            for v in variants}
    return model, inputs, res, eager


def test_two_variants_in_a_row_keep_their_own_graphs(tiny, monkeypatch):
    monkeypatch.setattr(common, "graphed", lambda device: True)
    with fake_runner() as log:
        _, _, res, eager = run_pair(["full", "nodenoise"])
    # full: its eager call, its capture (then a replay), the reps timed,
    # the launches' replay; nodenoise: its own three calls, then a full
    # graph made anew beside it and the two replayed in turns
    own = ["eager", "capture", "replay", "replay"]
    assert list(log) == (own + ["replay"] * 2 + own
                         + ["eager", "capture", "replay"]
                         + ["replay", "replay"] * 2)
    for v in ("full", "nodenoise"):
        for call in ("first", "second", "last"):
            assert torch.equal(res[v][call], eager[v])
    assert not torch.equal(eager["full"], eager["nodenoise"])


def test_a_key_without_the_variant_replays_a_stale_graph(tiny, monkeypatch):
    """The hazard the variant key and ``capture.release()`` between
    variants guard against."""
    monkeypatch.setattr(common, "graphed", lambda device: True)
    with fake_runner() as log:
        model, inputs, _, eager = run_pair(["full", "nodenoise"], reps=1)
        ins = {"x": inputs["x_init"]}
        calls = []
        for v in ("full", "nodenoise"):
            body = (lambda ins, v=v: eager[v] + 0 * ins["x"])
            for _ in range(2):
                calls.append(common.run_body(("same key",), body, ins,
                                             model.net, model.device))
        assert log[-5:] == ["eager", "capture", "replay", "replay",
                            "replay"]
    # the nodenoise calls replayed the full body's graph
    assert all(torch.equal(c, eager["full"]) for c in calls)


def test_device_shift_names_the_kernels_that_moved():
    """Where a variant's marginal went, from two profiles' device ms by
    kernel name (the card's ``[device]`` lines), per step."""
    full = {"busy_ms": 30.0, "by_name": {"gemm": 12.0, "patch": 1.0,
                                         "index_add": 0.5, "sort": 2.0}}
    variant = {"busy_ms": 29.9, "by_name": {"gemm": 12.0, "index_add": 2.0,
                                            "sort": 2.1, "stub": 0.3}}
    got = step_tool.device_shift(full, variant, steps=10)
    assert got["busy_ms_per_step"] == pytest.approx(2.99)
    assert got["busy_saved_ms"] == pytest.approx(0.01)
    assert [m["name"] for m in got["moved"]] == ["index_add", "patch",
                                                 "stub"]
    assert [m["saved_ms"] for m in got["moved"]] == pytest.approx(
        [-0.15, 0.1, -0.03])

