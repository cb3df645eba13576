"""The yardstick's frozen arithmetic: FLOP counts from the configuration's
widths against the program's own network, the Chamfer kNN's operations and
bytes, the published peaks, and the trace reduction on a synthetic
trace."""

import json
from pathlib import Path

import pytest

from h100_bench.core import model_spec, peaks, trace
from h100_bench.flops import chamfer_knn, pcst_model

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "h100_bench/configs/pcst-120k-hier.json")
                 .read_text())


def program_shapes():
    from pointcloud_style_transfer_torch.models.networks import DiffusionNet
    return {k: tuple(v.shape) for k, v in DiffusionNet().state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_spec_is_the_programs_network():
    assert model_spec.shapes(CFG) == program_shapes()
    assert model_spec.parameter_count(CFG) == CFG["parameters"] == 2549827


def test_denoiser_macs_from_the_programs_shapes():
    shapes = program_shapes()
    per_point = sum(
        shapes[f"{name}.weight"][0] * shapes[f"{name}.weight"][1]
        for name, _, _ in model_spec.denoiser_point_layers(CFG))
    assert per_point == pcst_model.denoiser_macs_per_point(CFG) == 1770240


def test_encoder_macs_by_hand():
    sa1 = 512 * 32 * (3 * 64 + 64 * 64 + 64 * 128)
    sa2 = 128 * 64 * (131 * 128 + 128 * 128 + 128 * 256)
    sa3 = 128 * (259 * 256 + 256 * 512 + 512 * 256)
    head = 256 * 512 + 512 * 256
    assert pcst_model.encoder_macs(CFG) == sa1 + sa2 + sa3 + head


def test_serve_flops_per_cloud():
    hier = pcst_model.serve_flops_per_cloud(CFG, 50, True)
    # 10.6 TFLOP a hierarchical cloud: the denoiser on 2 x 30,000 rows
    assert hier == pytest.approx(2 * 50 * 2 * 30000 * 1770240, rel=1e-3)
    direct = pcst_model.serve_flops_per_cloud(CFG, 50, False)
    assert direct / hier == pytest.approx(4.0, rel=1e-3)


def test_train_forward_flops():
    f = pcst_model.train_forward_flops(CFG, 4, True)
    assert f == 2 * 4 * (pcst_model.encoder_macs(CFG) + 30000 * 1770240
                         + pcst_model.denoiser_macs_per_cloud(CFG))


def test_chamfer_knn_counts_and_bound():
    assert chamfer_knn.flops(4, 30000, 30000) == 8 * 4 * 30000 ** 2
    assert chamfer_knn.bytes_moved(1, 10, 20) == (30 * 12 + 10 * 8)
    # 4 x 30k x 30k is bound by operations: 0.43 ms on 67 TFLOP/s
    assert chamfer_knn.least_seconds(4, 30000, 30000) == pytest.approx(
        8 * 4 * 30000 ** 2 / 67e12)


def test_published_peaks():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S) == \
        (989e12, 67e12, 3.35e12)


def test_union_counts_overlaps_once():
    assert trace.union_length([(0, 10), (5, 15), (20, 30), (29, 31)]) == 26
    assert trace.union_length([]) == 0
    assert trace.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]


def test_reduce_a_synthetic_trace():
    W = trace.WINDOW
    events = [
        (W, False, 100, 200),
        ("request.sampler_call", False, 100, 150),
        ("cudaMemcpyAsync", False, 150, 190),
        ("_ZN12_GLOBAL__N_115knn_topk_kernelILi1EEEvPKf", True, 110, 130),
        ("ampere_gemm", True, 120, 140),   # overlaps the kNN
        ("ampere_gemm", True, 160, 170),
        ("outside", True, 10, 20),         # before the window: not counted
    ]
    s = trace.reduce(events, units=2)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(40e-9)        # 110-140 and 160-170
    ops = dict(s.breakdown["device_ops"])
    assert ops["knn_topk_kernel<1>"] == pytest.approx(20e-9)
    assert ops["ampere_gemm"] == pytest.approx(30e-9)
    idle = dict(s.breakdown["idle_gaps"])
    # each idle instant goes to what the host ran then: 100-110 and
    # 140-150 to the sampler call, 150-160 and 170-190 to the copy,
    # 190-200 to Python between operators
    assert idle["request.sampler_call"] == pytest.approx(20e-9)
    assert idle["cudaMemcpyAsync"] == pytest.approx(30e-9)
    assert idle["host idle (Python)"] == pytest.approx(10e-9)
    assert s.units == 2 and len(s.kernels) == 3


def test_kernel_names():
    assert trace.kernel_name(
        "void (anonymous namespace)::grid_interp_kernel<3>(float const*)") \
        == "grid_interp_kernel<3>"
    name = "void at::native::vectorized_elementwise_kernel<8, at::native::x>"
    assert trace.kernel_name(name) == name
    assert trace.kernel_name("_ZN12_GLOBAL__N_115knn_topk_kernelILi3EEEvv") \
        == "knn_topk_kernel<3>"
