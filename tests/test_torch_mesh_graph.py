"""The multi-rank paths as one device program, held on the CPU: the
point-sharded sampler (``guided_sample_loop(mesh=)``) and the meshed
trainer's train and eval steps routed through the capture runner
(``models.capture.run_captured(groups=)``) on gloo groups of 2 and 4 ranks
(``torch_dist``), the runner's eager run and capture replaced by CPU
stand-ins (``torch_dist.fake_runner``: a capture runs the body once and
puts back the state it wrote, a replay runs it on the static inputs), as
``test_torch_graph_runner.py`` does in one process.

* The routed meshed sampler ({points: 2} and {points: 4}; 256 points, 64
  coarse, 3 steps, the brute-force kNN and the kd-grid) takes the branches
  eager, capture, replay, replay and is bit-identical to the eager meshed
  call on every rank, every rank returning the same cloud.
* The routed meshed trainer (``STEP_MESHES``: {data: 2}, and {data: 2,
  points: 2} point-sharded): 4 mini-steps (accumulation 2) and 3 eval
  steps bit-identical to an eager meshed trainer's (loss terms, emit, and
  after them every parameter, buffer, optimizer and EMA tensor), the
  first ones with the global batch's draws given to both, the others with
  each trainer drawing from its own identically seeded generator: the
  routed one in ``_captured``, for the B * d clouds and the gathered
  points, the eager one in ``StepLayout.localize``. The eager meshed step is held to the
  single-device step in ``test_torch_sharded_step.py``, and that one to
  JAX elsewhere, so bit-identity carries the parity over.
* Runner states that disagree (rank 1's entry dropped, or its owner
  replaced) still give every rank the same branches; with the agreement
  patched out they differ. One rank's failed capture raises on both ranks
  within the group's deadline, and the next call runs eagerly on both.
* Two meshes, a changed ``_TEST_SHARD_OFFSET`` and two ranks' places never
  share a key.
* ``NoSyncGuard`` (``torch_nosync.py``) refuses no host read in the meshed
  sampler body nor in the meshed train and eval step bodies.

The CUDA graphs with NCCL collectives inside are held on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py`` ``[parallel]`` and
``[parallel graph]``).
"""

import json
import weakref

import numpy as np
import pytest
import torch

import torch_dist
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (PointCloudDiffusionModel,
                                                    capture)

WORLDS = (2, 4)
BACKENDS = ("brute", "grid")
ROUTED = ["eager", "capture", "replay", "replay"]  # three calls


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    torch.manual_seed(1)
    cfg = torch_dist.SAMPLER_CFG
    net = PointCloudDiffusionModel(Config(**cfg), device="cpu").net
    rng = np.random.default_rng(11)
    f32 = np.float32
    steps = torch_dist.SAMPLER_STEPS
    inputs = dict(
        src=rng.standard_normal((1, 256, 3)).astype(f32),
        cond=rng.standard_normal((1, 256, 3)).astype(f32),
        x_init=rng.standard_normal((1, 256, 3)).astype(f32),
        cond_priority=rng.uniform(size=(1, 256)).astype(f32),
        step_priorities=rng.uniform(size=(steps, 1, 256)).astype(f32),
        fps_starts=np.zeros((2, 1), np.int64),
        # a dense condition cloud, as tests/test_torch_sharded_step.py's
        sim=rng.standard_normal((4, 256, 3)).astype(f32),
        real=(rng.standard_normal((4, 256, 3)) * 0.3).astype(f32))
    tmps, started = {}, []
    try:
        for world in WORLDS:
            tmp = tmps[world] = tmp_path_factory.mktemp(f"mesh_graph{world}")
            torch.save(net.state_dict(), tmp / "weights.pt")
            (tmp / "sampler_cfg.json").write_text(json.dumps(cfg))
            np.savez(tmp / "inputs.npz", **inputs)
            started.append(torch_dist.start_group(
                torch_dist.mesh_graph_ranks, world, tmp))
    finally:
        ranks = torch_dist.join_groups(*started)
    return dict(zip(tmps, ranks))


def branches(r, key):
    return r[key].tolist()


# -- the point-sharded sampler -------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("world", WORLDS)
def test_routed_sampler_identical_to_eager(groups, world, backend):
    for r in groups[world]:
        eager = r[f"sampler.{backend}.eager"]
        assert eager.shape == (1, 256, 3) and np.isfinite(eager).all()
        for routed in r[f"sampler.{backend}.routed"]:
            np.testing.assert_array_equal(routed, eager)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("world", WORLDS)
def test_routed_sampler_branches_and_ranks(groups, world, backend):
    ranks = groups[world]
    for r in ranks:
        assert branches(r, f"sampler.{backend}.branches") == ROUTED
        np.testing.assert_array_equal(r[f"sampler.{backend}.routed"],
                                      ranks[0][f"sampler.{backend}.routed"])


# -- the meshed trainer --------------------------------------------------

@pytest.mark.parametrize("part", ["terms", "emits", "evals", "state"])
@pytest.mark.parametrize("world", WORLDS)
def test_routed_steps_identical_to_eager(groups, world, part):
    """4 mini-steps and 3 eval steps: the first 2 mini-steps and the first
    eval step with the global batch's draws given to both trainers, the
    others drawn from each trainer's own generator, by the routed trainer
    in ``_captured`` and by the eager one in ``StepLayout.localize``."""
    for r in groups[world]:
        np.testing.assert_array_equal(r[f"steps.routed.{part}"],
                                      r[f"steps.eager.{part}"])
    r = groups[world][0]
    assert r["steps.eager.emits"].tolist() == [False, True, False, True]
    assert np.isfinite(r["steps.eager.terms"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_routed_steps_draw_as_the_eager_ones(groups, world):
    """Both trainers took their own draws (the generator moved) and the
    same number of them; every rank drew alike."""
    ranks = groups[world]
    for r in ranks:
        routed, eager = r["steps.routed.generator"], r["steps.eager.generator"]
        np.testing.assert_array_equal(routed, eager)
        np.testing.assert_array_equal(routed, ranks[0]["steps.routed."
                                                       "generator"])
        assert not np.array_equal(routed, r["steps.routed.seeded"])


@pytest.mark.parametrize("world", WORLDS)
def test_routed_steps_branches(groups, world):
    """4 mini-steps, then 3 eval steps: each kind eager, captured, then
    replayed, on every rank; every rank ends in the same state."""
    ranks = groups[world]
    for r in ranks:
        assert branches(r, "steps.routed.branches") == \
            ROUTED + ["replay"] + ROUTED
        np.testing.assert_array_equal(r["steps.routed.state"],
                                      ranks[0]["steps.routed.state"])


# -- agreement -----------------------------------------------------------

@pytest.mark.parametrize("case", ["drop", "owner"])
def test_ranks_agree_on_branches(groups, case):
    """Rank 1 would run its second call eagerly (its entry dropped, or a
    new owner) while rank 0 would capture: both run it eagerly, then both
    capture and replay."""
    want = ["eager", "eager", "capture", "replay", "replay"]
    for r in groups[2]:
        assert branches(r, f"agree.{case}") == want


def test_unagreed_branches_differ(groups):
    """Negative control: without the agreement rank 0 captures at the
    second call while rank 1 runs it eagerly."""
    r0, r1 = groups[2]
    assert branches(r0, "agree.unagreed") == ["eager", "capture", "replay",
                                              "replay", "replay"]
    assert branches(r1, "agree.unagreed") == ["eager", "eager", "capture",
                                              "replay", "replay"]


def test_failed_capture_raises_on_every_rank(groups):
    r0, r1 = groups[2]
    assert branches(r0, "fail.errors") == [
        "none", "the capture failed on another rank of the process group",
        "none"]
    assert branches(r1, "fail.errors") == ["none", "the stand-in capture "
                                           "failed", "none"]
    # rank 0 captured (and replayed nothing); both forgot the key
    assert branches(r0, "fail.branches") == ["eager", "capture", "eager"]
    assert branches(r1, "fail.branches") == ["eager", "eager"]


# -- keys ----------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_meshes_and_places_never_share_a_key(groups, world):
    """The sampler on {points: world}: eager, captured; on another mesh,
    and with ``_TEST_SHARD_OFFSET = 1``, eager again (new keys); on the
    first mesh, a replay. Each rank's split and layout keys all differ,
    and the ranks' places give each rank its own."""
    ranks = groups[world]
    for r in ranks:
        assert branches(r, "keys.calls") == [
            "eager", "capture+replay", "eager", "eager", "replay"]
        mine = branches(r, "keys.mine")
        assert len(set(mine)) == len(mine)
    every = np.asarray(ranks[0]["keys.every"]).reshape(world, -1)
    for column in (0, 5):  # {points: world}'s split, {data: world}'s layout
        assert len(set(every[:, column])) == world


# -- no host reads -------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_meshed_bodies_read_nothing_back(groups, world):
    """Under the guard the meshed sampler gives the eager meshed cloud and
    the meshed steps finite terms (a host read would have raised)."""
    for r in groups[world]:
        for backend in BACKENDS:
            np.testing.assert_array_equal(r[f"guard.sampler.{backend}"],
                                          r[f"sampler.{backend}.eager"])
        assert np.isfinite(r["guard.step.terms"]).all()
        assert np.isfinite(r["guard.step.evals"]).all()
        assert r["guard.step.emits"].tolist() == [False, True]


# -- the runner's agreement in one process ---------------------------------

@pytest.fixture
def stand_ins(monkeypatch):
    """The runner with CPU stand-ins for its eager run and its capture and
    empty caches; yields the log of branches taken."""
    log = []
    monkeypatch.setattr(capture, "_ENTRIES", {})
    monkeypatch.setattr(capture, "_eager", lambda body, ins: (
        log.append("eager"), body(ins))[1])

    def fake_capture(body, inputs):
        log.append("capture")
        static = {n: t.clone() for n, t in inputs.items()}
        output = body(static)
        return capture._Graph(torch_dist.FakeGraph(body, static, output,
                                                   log),
                              static, output, None, {})
    monkeypatch.setattr(capture, "_capture", fake_capture)
    return log


def test_runner_agrees_each_call_and_each_capture(stand_ins, monkeypatch):
    """With ``groups`` the runner asks ``agree`` for each call's branch
    (its own state's) and, after a capture, whether every rank made one;
    without, never. The agreed branch is taken whatever the local one."""
    seen = []
    answers = iter([capture.EAGER, capture.EAGER, capture.CAPTURE, 1,
                    capture.REPLAY])

    def agree(groups, value):
        seen.append((tuple(groups), value))
        return next(answers)
    monkeypatch.setattr(capture, "agree", agree)
    owner = torch_dist.Owner()
    x = {"x": torch.arange(2.0)}
    for _ in range(4):
        out = capture.run_captured(("k",), lambda ins: ins["x"] + 1, x,
                                   owner, groups=["g"])
        assert torch.equal(out, x["x"] + 1)
    # the second call's own branch (capture) was overruled: eager again
    assert seen == [(("g",), capture.EAGER), (("g",), capture.CAPTURE),
                    (("g",), capture.CAPTURE), (("g",), 1),
                    (("g",), capture.REPLAY)]
    assert stand_ins == ["eager", "eager", "capture", "replay", "replay"]
    seen.clear()
    capture.run_captured(("k2",), lambda ins: ins["x"], x, owner)
    assert seen == []


def test_release_drops_every_graph(stand_ins):
    """``capture.release`` forgets every cache's keys: a captured key's
    next call runs eagerly again."""
    owner = torch_dist.Owner()
    x = {"x": torch.arange(2.0)}
    for cache in ("sampler", "step"):
        for _ in range(2):
            capture.run_captured(("k",), lambda ins: ins["x"], x, owner,
                                 cache=cache)
    assert stand_ins == ["eager", "capture", "replay"] * 2
    capture.release()
    assert capture._ENTRIES == {}
    capture.run_captured(("k",), lambda ins: ins["x"], x, owner)
    assert stand_ins[-1] == "eager"


def test_release_empties_a_cache_a_caller_holds(stand_ins):
    """A caller that still holds a cache (``chip_smoke.py --ranks`` held
    the trainer's, to find its train graph) holds no graph after
    ``release``: on four cards a graph alive at
    ``destroy_process_group`` holds its NCCL communicator, and that run
    hung at its end."""
    owner = torch_dist.Owner()
    x = {"x": torch.arange(2.0)}
    for _ in range(2):
        capture.run_captured(("k",), lambda ins: ins["x"], x, owner,
                             cache="step")
    held = capture._ENTRIES["step"]
    graph = weakref.ref(next(iter(held.values())).graph.graph)
    assert graph() is not None
    capture.release()
    assert len(held) == 0 and graph() is None
