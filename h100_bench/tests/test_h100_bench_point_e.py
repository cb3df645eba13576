"""The transformer cell's and the batched cell's benchmark pieces on the
CPU: the spec against the program's network, the FLOP count by hand, the
readers' arithmetic on synthetic traces and span logs, and whole runs of
both drivers at a tiny size (2,048-point clouds, a 64-wide 2-block
transformer), whose traced line reads the span metrics from the log the
driver records."""

import json
import time
from pathlib import Path

import pytest
import torch

from h100_bench.core import harness, point_e_spec, program_spans, trace
from h100_bench.flops import point_e
from pointcloud_style_transfer_torch.utils.profiling import Span

from test_h100_bench_runs import check_line, run_line, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "h100_bench/configs/pcst-120k-pointe300m.json")
                 .read_text())
BENCH = harness.load_benchmark()
NEW = ["mfu.serve_pointe", "attention_roofline", "block_attention_ms.serve",
       "block_mlp_ms.serve"]


def test_spec_is_the_programs_network():
    from pointcloud_style_transfer_torch.models import DiffusionNet
    from pointcloud_style_transfer_torch.models.transformer import (
        TransformerSpec)
    d = CFG["denoiser"]
    spec = TransformerSpec(d["width"], d["layers"], d["heads"],
                           d["mlp_ratio"], CFG["feature_dim"])
    with torch.device("meta"):
        net = DiffusionNet(CFG["feature_dim"], CFG["time_embed_dim"],
                           denoiser=spec)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert point_e_spec.shapes(CFG) == shapes
    assert point_e_spec.parameter_count(CFG) == CFG["parameters"] == \
        311_652_675


def test_weights_qk_gain():
    cfg = dict(CFG, denoiser=dict(CFG["denoiser"], width=64, layers=1,
                                  heads=4))
    w = point_e_spec.make(cfg, 3, "cpu")
    qkv = w["noise_predictor.backbone.resblocks.0.attn.c_qkv.weight"]
    rows = qkv.view(4, 3, 16, 64)  # head, [q | k | v], channel, in
    assert point_e_spec.qk_rows(cfg).view(4, 3, 16)[:, :2].all()
    assert not point_e_spec.qk_rows(cfg).view(4, 3, 16)[:, 2].any()
    ratio = rows[:, :2].std() / rows[:, 2].std()
    assert ratio == pytest.approx(point_e_spec.QK_GAIN, rel=0.1)
    out = w["noise_predictor.output_proj.weight"]
    assert out.abs().max() > 0
    assert float(out.std() * 8) == pytest.approx(point_e_spec.OUTPUT_GAIN,
                                                 rel=0.2)  # fan-in 64
    assert (w["noise_predictor.ln_pre.weight"] - 1).abs().max() < 0.5


def test_flops_by_hand():
    d, L, T, B, H = 1024, 24, 4098, 2, 16
    gemms = 2 * B * T * L * 12 * d * d
    attention = L * 4 * B * H * T * T * 64
    assert gemms == pytest.approx(4.95e12, rel=5e-3)
    assert attention == pytest.approx(3.30e12, rel=5e-3)
    step = point_e.denoiser_flops(CFG, 2, point_e.tokens(CFG))
    assert point_e.tokens(CFG) == T
    assert step == pytest.approx(8.25e12, rel=5e-3)
    assert step == pytest.approx(gemms + attention, rel=2e-3)
    assert point_e.attention_flops(CFG, B, T) == 4 * B * H * T * T * 64
    assert point_e.attention_bytes(CFG, B, T) == 4 * B * T * d * 2
    # compute-bound: 0.139 ms on 989 TFLOP/s against 0.020 on 3.35 TB/s
    assert point_e.attention_least_seconds(CFG, B, T) == pytest.approx(
        4 * B * H * T * T * 64 / 989e12)
    cloud = point_e.serve_flops_per_cloud(CFG, 50, True)
    assert cloud == pytest.approx(50 * step, rel=1e-4)


def run_of(cell, **state):
    run = harness.Run(harness.find_cell(BENCH, cell), 5, 1.0, True,
                      torch.device("cpu"), time.perf_counter())
    run.state.update(state)
    return run


def read(name, run):
    return harness.reader(name)(run)


def test_attention_roofline_on_a_synthetic_trace():
    run = run_of("serve-pointe300m-b1")
    assert read("attention_roofline", run) is None  # no trace
    kernels = [("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_"
                "traits<64, 128, 128, 4>>(Flash_fwd_params)", 3e-4),
               ("ampere_bf16_s16816gemm_bf16_128x128", 1e-3)] * (3 * 50 * 24)
    run.trace_summary = trace.Summary(1.0, 1.0, 3, kernels, {})
    least = point_e.attention_least_seconds(CFG, 2, 4098)
    assert read("attention_roofline", run) == pytest.approx(
        100 * least / 3e-4)
    run.trace_summary = trace.Summary(1.0, 1.0, 3, kernels[1:2], {})
    assert read("attention_roofline", run) is None  # no fused kernel
    assert read("attention_roofline", run_of("serve-hier-b1")) is None


def test_mfu_serve_pointe():
    run = run_of("serve-pointe300m-b1")
    run.records = [{"units": 1}] * 10
    run.window_s = 10.0
    per_cloud = point_e.serve_flops_per_cloud(CFG, 50, True)
    assert read("mfu.serve_pointe", run) == pytest.approx(
        100 * per_cloud / 989e12)
    assert read("mfu.serve_pointe", run_of("serve-hier-b1")) is None


def test_block_readers_take_the_replayed_calls_alone():
    spans, ids = [], iter(range(1, 10 ** 6))

    def call(c, branch, ms):
        top = next(ids)
        spans.append(Span(top, f"capture.{branch}", c, None, "host", 0,
                          10 ** 6))
        for name in ("denoiser.attention", "denoiser.mlp"):
            for k in range(2):
                spans.append(Span(next(ids), name, c, top, "device", 0,
                                  round((ms + k) * 1e6)))
    call(1, "eager", 50.0)
    call(2, "capture", 50.0)
    call(3, "replay", 0.25)
    call(4, "replay", 0.75)
    run = run_of("serve-pointe300m-b1")
    run.state[program_spans.KEY] = {"host": spans, "device": spans}
    assert read("block_attention_ms.serve", run) == pytest.approx(1.0)
    assert read("block_mlp_ms.serve", run) == pytest.approx(1.0)
    run.state[program_spans.KEY] = None
    assert read("block_attention_ms.serve", run) is None


def test_new_entries_appended_for_the_new_cell():
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"]][-len(NEW):] == NEW
    for name in NEW:
        assert by_name[name]["workloads"] == ["serve-pointe300m-b1"]
        assert by_name[name]["moves"] == "clouds_per_s"
    for name in ("mfu.serve", "grid_unsafe_pct.serve"):
        assert "serve-pointe300m-b1" not in by_name[name]["workloads"]
    for name in ("denoiser_ms.serve", "upsample_ms.serve",
                 "grid_unsafe_pct.serve"):
        assert "serve-hier-b8" not in by_name[name]["workloads"]


def tiny_pointe():
    cell = tiny_cell("serve-pointe300m-b1", steps=2)
    cell.config["denoiser"] = dict(cell.config["denoiser"], width=64,
                                   layers=2, heads=4)
    return cell


@pytest.mark.parametrize("trace_on", [0, 1])
def test_pointe_driver_line(trace_on, capsys):
    cell = tiny_pointe()
    line = run_line(cell, trace_on, capsys)
    check_line(line, cell, trace_on)
    assert set(line["check"]) == set(cell.check["limits"])
    if trace_on:
        for name in ("mfu.serve_pointe", "host_ms_per_call.serve",
                     "device_idle_pct.serve"):
            assert name in line["metrics"], name


def test_pointe_trace_fills_the_span_log():
    """A traced run leaves the program's spans where every reader finds
    them: both stretches, the transformer's spans in the device one (on
    the CPU a device span takes the host's clock, and no call replays a
    graph, so the readers themselves read None here)."""
    cell = tiny_pointe()
    run = harness.Run(cell, 2 ** 33 + 1, 0.2, True, torch.device("cpu"),
                      time.perf_counter())
    driver = harness.driver_of(cell)
    driver.setup(run)
    driver.window(run)
    driver.trace(run)
    logs = run.state[program_spans.KEY]
    assert set(logs) == {program_spans.HOST, program_spans.DEVICE}
    names = [sp.name for sp in logs[program_spans.DEVICE]]
    steps = cell.traffic["steps"]
    calls = program_spans.WARM_CALLS + cell.traffic["trace_requests"]
    assert names.count("denoiser.attention") == calls * steps * 2
    assert names.count("sampler.denoiser") == calls * steps
    assert "denoiser.attention" not in [
        sp.name for sp in logs[program_spans.HOST]]


def stand_in_call(run, i):
    """A replayed sampler call's spans, as the card records them: one step
    of the transformer's two blocks on the device's clock."""
    from pointcloud_style_transfer_torch.utils import profiling
    S = profiling._S
    S.calls += 1
    S.ids += 1
    top = S.ids
    S.log.append(Span(top, "capture.replay", S.calls, None, "host", 0,
                      10 ** 6))
    for name, ms in (("sampler.step", 20.0), ("sampler.denoiser", 18.0),
                     ("denoiser.attention", 0.5), ("denoiser.mlp", 0.25),
                     ("denoiser.attention", 0.75), ("denoiser.mlp", 0.25)):
        S.ids += 1
        clock = "device" if profiling.device_spans_on() else "host"
        S.log.append(Span(S.ids, name, S.calls, top, clock, 0,
                          round(ms * 1e6)))


def test_span_log_of_a_stand_in_reads_the_span_metrics():
    from h100_bench.core.span_log import span_log
    run = run_of("serve-pointe300m-b1", next_id=0)
    run.state[program_spans.KEY] = span_log(run, stand_in_call)
    assert read("step_denoiser_ms.serve", run) == pytest.approx(18.0)
    assert read("step_ms.serve", run) == pytest.approx(20.0)
    assert read("block_attention_ms.serve", run) == pytest.approx(0.625)
    assert read("block_mlp_ms.serve", run) == pytest.approx(0.25)
    assert read("replay_launch_ms.serve", run) == pytest.approx(1.0)
    assert run.state["next_id"] == 2 * run.cell.traffic["trace_requests"] \
        + program_spans.WARM_CALLS


@pytest.mark.parametrize("trace_on", [0, 1])
def test_batch_driver_line(trace_on, capsys):
    cell = tiny_cell("serve-hier-b8", steps=2, batch=2)
    line = run_line(cell, trace_on, capsys)
    check_line(line, cell, trace_on)
    assert line["attempted"] >= 1
    if trace_on:
        assert "mfu.serve" in line["metrics"]
