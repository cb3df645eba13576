"""The port's span log (``utils.profiling``) inside the sampler's and the
trainer's bodies, on the CPU at small sizes, and on the card (``cuda``).

* A hierarchical ``guided_sample_loop`` with spans recorded logs, per call,
  one ``sampler.step`` a step holding ``sampler.partition``,
  ``sampler.denoiser`` and ``sampler.upsample``, all under one call id,
  after the call's ``sampler.draws``; with spans off it logs nothing; the
  answer is the same bits either way. The direct branch logs steps holding
  ``sampler.denoiser`` alone.
* One ``train_step`` logs ``train.forward``, ``train.backward`` and
  ``train.optimizer`` once each; a trainer step routed through the capture
  runner adds ``train.draws`` and the runner's spans to the same call.
* ``annotate`` and ``device_span`` are one shared no-op with neither a
  profiler nor the log on; with the host's spans alone recorded the body
  logs nothing.
* On the card: a recording replay gives the same bits as a replay with
  spans off; each step's children fit in it; the steps fit in the device
  time of the replay, between an event pair around it.
"""

import collections
import contextlib

import pytest
import torch

from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    PointCloudDiffusionModel, capture, guided_sample_loop, make_schedule)
from pointcloud_style_transfer_torch.training import (DiffusionTrainer,
                                                      ema_init,
                                                      make_optimizer,
                                                      train_step)
from pointcloud_style_transfer_torch.training.trainer import step_draws
from pointcloud_style_transfer_torch.utils import profiling

from test_torch_graph_nosync import small_grids

N, M, STEPS = 1024, 256, 3
STAGES = ("sampler.partition", "sampler.denoiser", "sampler.upsample")


@pytest.fixture
def model(monkeypatch):
    torch.manual_seed(0)
    cfg = Config(total_points=N, global_points=M, feature_dim=32,
                 time_embed_dim=16, use_amp=False, knn_backend="grid")
    small_grids(monkeypatch)
    return PointCloudDiffusionModel(cfg, device="cpu"), make_schedule(cfg)


def sample(model, schedule, device="cpu", hierarchical=True, seed=3,
           n=N):
    g = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn((1, n, 3), generator=g, device=device) * 0.8
    cond = torch.randn((1, n, 3), generator=g, device=device) * 0.8
    return guided_sample_loop(model, schedule, src, cond, STEPS, 7.5,
                              use_hierarchical=hierarchical, generator=g)


def by_call(spans):
    calls = collections.defaultdict(list)
    for s in spans:
        calls[s.call].append(s)
    return calls


def children(spans, parent):
    return sorted(s.name for s in spans if s.parent == parent.id)


def test_hierarchical_loop_logs_each_step_and_its_stages(model):
    net, schedule = model
    off = sample(net, schedule)
    with profiling.recording_spans():
        on = [sample(net, schedule) for _ in range(2)]
    log = profiling.spans()
    assert all(torch.equal(o, off) for o in on)  # the same bits
    calls = by_call(log)
    assert len(calls) == 2 and None not in calls
    for spans in calls.values():
        steps = [s for s in spans if s.name == "sampler.step"]
        assert len(steps) == STEPS
        for step in steps:
            assert step.parent is None and step.clock == profiling.HOST
            assert children(spans, step) == sorted(STAGES)
            for c in spans:
                if c.parent == step.id:
                    assert step.start_ns <= c.start_ns <= c.end_ns \
                        <= step.end_ns
        (draws,) = [s for s in spans if s.name == "sampler.draws"]
        assert draws.end_ns <= min(s.start_ns for s in steps)
        assert len(spans) == 1 + 4 * STEPS
    with profiling.recording_spans():
        pass
    again = sample(net, schedule)  # spans off: nothing logged
    assert profiling.spans() == [] and torch.equal(again, off)


def test_host_spans_alone_leave_the_body_unmarked(model):
    net, schedule = model
    with profiling.recording_spans(device=False):
        assert not profiling.device_spans_on()
        sample(net, schedule)
    assert [s.name for s in profiling.spans()] == ["sampler.draws"]


def test_direct_loop_logs_the_denoiser_alone(model):
    net, schedule = model
    with profiling.recording_spans():
        sample(net, schedule, hierarchical=False, n=M)
    spans = profiling.spans()
    steps = [s for s in spans if s.name == "sampler.step"]
    assert len(steps) == STEPS
    for step in steps:
        assert children(spans, step) == ["sampler.denoiser"]
    assert sorted({s.name for s in spans}) == [
        "sampler.denoiser", "sampler.draws", "sampler.step"]


TINY = dict(total_points=256, global_points=64, feature_dim=16,
            time_embed_dim=8, num_timesteps=20, use_amp=False, num_workers=0,
            batch_size=2)


def clouds(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((1, 256, 3), generator=g),
            torch.randn((1, 256, 3), generator=g))


def test_train_step_logs_forward_backward_optimizer_once():
    torch.manual_seed(0)
    cfg = Config(**TINY)
    model = PointCloudDiffusionModel(cfg, device="cpu")
    params = dict(model.net.named_parameters())
    opt, ema = make_optimizer(cfg, params), ema_init(params)
    sim, real = clouds()
    draws = step_draws(model, 1, 256, 256, train=True,
                       generator=torch.Generator().manual_seed(1))
    with profiling.recording_spans():
        train_step(model, make_schedule(cfg), opt, ema, sim, real,
                   torch.tensor(1e-3), draws=draws)
    spans = profiling.spans()
    assert [s.name for s in spans] == [
        "train.forward", "train.backward", "train.optimizer"]
    assert len({s.call for s in spans}) == 1 and spans[0].call is not None
    assert all(s.parent is None for s in spans)
    assert spans[0].end_ns <= spans[1].start_ns
    assert spans[1].end_ns <= spans[2].start_ns


def test_routed_train_step_shares_one_call(tmp_path, monkeypatch):
    """A trainer step through the runner (its eager run and capture CPU
    stand-ins): ``train.draws``, the runner's spans and the body's spans
    share the call; the body's nest under the runner's branch."""
    monkeypatch.setattr(capture, "_ENTRIES", {})
    monkeypatch.setattr(capture, "_eager", lambda body, ins: body(ins))
    cfg = Config(**TINY, gradient_accumulation_steps=3,
                 checkpoint_dir=str(tmp_path / "ckpt"),
                 log_dir=str(tmp_path / "logs"),
                 result_dir=str(tmp_path / "results"))
    trainer = DiffusionTrainer(cfg, resume=False, device="cpu")
    monkeypatch.setattr(trainer, "_graphed", lambda draws: True)
    with profiling.recording_spans():
        trainer.train_step(*clouds(), 1e-3)
    spans = profiling.spans()
    assert len({s.call for s in spans}) == 1
    names = [s.name for s in spans]
    assert names[:2] == ["train.draws", "capture.key"]
    (eager,) = [s for s in spans if s.name == "capture.eager"]
    assert children(spans, eager) == sorted(
        ["train.forward", "train.backward", "train.optimizer"])


def test_no_op_with_neither_profiler_nor_log():
    assert not profiling.device_spans_on()
    assert not torch.autograd._profiler_enabled()
    for span in (profiling.annotate("a"), profiling.device_span("b"),
                 profiling.body_spans()):
        assert isinstance(span, contextlib.nullcontext)
    assert profiling.annotate("a") is profiling.device_span("b")
    with torch.profiler.profile():
        assert isinstance(profiling.annotate("a"),
                          torch.profiler.record_function)
        assert isinstance(profiling.device_span("b"),
                          contextlib.nullcontext)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (spans timed by events in a graph)")
    torch.manual_seed(0)
    cfg = Config(total_points=4096, global_points=1024, feature_dim=32,
                 time_embed_dim=16)
    return (PointCloudDiffusionModel(cfg, device="cuda"),
            make_schedule(cfg).to("cuda"))


@pytest.mark.cuda
def test_recording_replay_matches_and_steps_fit(card_model):
    net, schedule = card_model
    capture.release()
    off = [sample(net, schedule, "cuda", n=4096) for _ in range(3)]
    assert torch.equal(off[1], off[2])  # captured, then replayed
    with profiling.recording_spans():
        on = [sample(net, schedule, "cuda", n=4096) for _ in range(2)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        on.append(sample(net, schedule, "cuda", n=4096))
        end.record()
    torch.cuda.synchronize()
    outer_ms = start.elapsed_time(end)
    assert all(torch.equal(o, off[2]) for o in on)
    spans = profiling.spans()
    last = by_call(spans)[max(s.call for s in spans)]
    assert "capture.replay" in {s.name for s in last}
    assert "capture.capture" not in {s.name for s in last}
    steps = [s for s in last if s.name == "sampler.step"]
    assert len(steps) == STEPS
    assert all(s.clock == profiling.DEVICE for s in steps)
    for step in steps:
        assert children(last, step) == sorted(STAGES)
        assert sum(c.ms for c in last if c.parent == step.id) <= step.ms
    assert sum(s.ms for s in steps) <= outer_ms
    capture.release()
