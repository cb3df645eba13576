"""Point-E's transformer denoiser (``models/transformer.py``) on the CPU at a
small size (width 64, 2 blocks, 4 heads, 256 + 2 tokens; 2,048-point
clouds, 256 coarse points): against the plain reference
``tests/reference_point_e.py`` (forward, the hierarchical guided sampler,
a training step's loss and clipped gradient), the benchmark's copy
``h100_bench/reference/point_e.py``, the presets and parameter counts, the
guards (point-sharded paths, pinned selections, no dropout), checkpoints,
``cli/inference.py`` and ``cli/train.py --denoiser``."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench.core import point_e_spec
from h100_bench.reference import point_e as bench_point_e
from h100_bench.reference.sampler import guided_transfer
from pointcloud_style_transfer_torch.config import Config
from pointcloud_style_transfer_torch.models import (
    PRESETS, DiffusionNet, PointCloudDiffusionModel, TransformerSpec,
    guided_sample_loop, make_schedule)
from pointcloud_style_transfer_torch.models import transformer
from pointcloud_style_transfer_torch.ops.kernels import LAUNCH_COUNTS
from pointcloud_style_transfer_torch.utils import profiling
from reference_point_e import PointERef, train_losses

ROOT = Path(__file__).resolve().parents[1]
CELL_CFG = json.loads((ROOT / "h100_bench/configs/pcst-120k-pointe300m.json")
                      .read_text())
F = 32  # the style width
SPEC = TransformerSpec(width=64, layers=2, heads=4, style_width=F)
SMALL = dict(total_points=2048, global_points=256, feature_dim=F,
             use_amp=False)


def bench_cfg(**over):
    """The cell's configuration at the tests' widths."""
    cfg = copy.deepcopy(CELL_CFG)
    cfg.update(feature_dim=F, style_head=[512, F], **over)
    cfg["set_abstractions"][2][3] = [256, 512, F]
    cfg["denoiser"] = {**cfg["denoiser"], "width": SPEC.width,
                       "layers": SPEC.layers, "heads": SPEC.heads}
    return cfg


@pytest.fixture(scope="module")
def weights():
    """The benchmark's seeded weights (peaked attention) at these widths."""
    return point_e_spec.make(bench_cfg(), 2 ** 35 + 7, "cpu")


def model_of(weights, **cfg):
    config = Config(**{**SMALL, **cfg})
    model = PointCloudDiffusionModel(config, "cpu", denoiser=SPEC)
    state = dict(weights)
    for name, t in model.net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(t)
    model.net.load_state_dict(state, strict=True)
    return model


def ref_of(weights, **kw):
    return PointERef(weights, SPEC.heads, F, **kw)


def inputs(seed=0, rows=256, batch=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, rows, 3), generator=g)
    t = torch.tensor([999, 17][:batch])
    style = torch.randn((batch, F), generator=g)
    return x, t, style


def test_presets_and_parameter_counts():
    assert PRESETS["base40M"] == TransformerSpec(512, 12, 8)
    assert PRESETS["base300M"] == TransformerSpec(1024, 24, 16)
    assert PRESETS["base1B"] == TransformerSpec(2048, 24, 32)
    assert all(s.mlp_ratio == 4 for s in PRESETS.values())
    with torch.device("meta"):
        net = DiffusionNet(256, denoiser=PRESETS["base300M"])
    n = sum(p.numel() for p in net.parameters())
    assert sum(p.numel() for p in net.noise_predictor.parameters()) == \
        310_977_539  # counted by hand from the widths
    assert n == CELL_CFG["parameters"] == 311_652_675
    assert point_e_spec.parameter_count(CELL_CFG) == n
    assert transformer.TransformerSpec.from_dict(
        PRESETS["base300M"].to_dict()) == PRESETS["base300M"]
    assert transformer.denoiser_spec(None) is None


def test_predict_noise_matches_reference_fp32(weights):
    """float32 against the plain reference: the same products in another
    order (SDPA's math path scales q k^T once, the reference q and k each;
    ``F.linear`` against ``@``), so agreement to float32 rounding of sums
    over 64-1,024 terms through 2 blocks: 2e-5 relative to the output's
    scale."""
    model = model_of(weights)
    x, t, style = inputs()
    got = model.predict_noise(x, t, style)
    want = ref_of(weights).predict_noise(x, t, style)
    assert got.dtype == torch.float32 and got.shape == (2, 256, 3)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 2e-5 * float(scale)


def test_predict_noise_bf16(weights):
    """bf16 compute (products, LayerNorm and GELU outputs, residual sums in
    bfloat16; statistics and softmax in float32) against the float32
    reference, by the RMS over the output's RMS: within 2.5% (bfloat16's
    2^-8 rounding carried through two blocks whose softmax rows are
    peaked; the benchmark's bfloat16-rounded reference reads 1.3-1.8% at
    these weights, its float8 control ~15%) and within 1.25x the
    bfloat16-rounded reference's own error. The largest point is not held
    to a bound: a peaked row's weight moves with a logit's rounding."""
    model = model_of(weights, use_amp=True)
    x, t, style = inputs(1)
    got = model.predict_noise(x, t, style)
    assert got.dtype == torch.bfloat16
    want = ref_of(weights).predict_noise(x, t, style)
    floor = bench_point_e.PointENet(weights, bench_cfg(), "bf16"
                                    ).predict_noise(x, t, style)

    def rms(e):
        return float(e.pow(2).mean().sqrt())
    err, floor_err = rms(got.float() - want), rms(floor - want)
    assert err <= 0.025 * rms(want)
    assert err <= 1.25 * floor_err
    assert err > 1e-3 * rms(want)  # really computed in bf16


def test_head_major_split(weights):
    """q, k and v come per head from [q | k | v] of 3c channels: the
    [Q | K | V] reading gives another answer, which the port is not."""
    model = model_of(weights)
    x, t, style = inputs(2)
    got = model.predict_noise(x, t, style)
    head_major = ref_of(weights).predict_noise(x, t, style)
    qkv_major = ref_of(weights, layout="qkv_major").predict_noise(
        x, t, style)
    scale = float(head_major.abs().max())
    assert float((got - head_major).abs().max()) <= 2e-5 * scale
    assert float((got - qkv_major).abs().max()) > 0.05 * scale


def test_bench_reference_equals_tests_copy(weights):
    cfg = bench_cfg()
    bench = bench_point_e.PointENet(weights, cfg, "fp32")
    x, t, style = inputs(3)
    got = bench.predict_noise(x, t, style)
    want = ref_of(weights).predict_noise(x, t, style)
    assert float((got - want).abs().max()) <= 2e-5 * float(
        want.abs().max())


def test_attention_counted_and_spanned(weights):
    model = model_of(weights)
    x, t, style = inputs(4)
    before = LAUNCH_COUNTS["attention"]
    model.predict_noise(x, t, style)
    assert LAUNCH_COUNTS["attention"] - before == SPEC.layers
    with profiling.recording_spans():
        model.predict_noise(x, t, style)
    names = [s.name for s in profiling.spans()]
    assert names.count("denoiser.attention") == SPEC.layers
    assert names.count("denoiser.mlp") == SPEC.layers
    assert names.count("denoiser.transformer") == 1
    model.predict_noise(x, t, style)  # nothing recorded outside the block
    assert len(profiling.spans()) == len(names)


def sampler_pair(weights, steps=10, window=None, seed=11, **cfg):
    """(the port's hierarchical guided sampler, the reference's) on one
    2,048-point pair with the same draws; ``window`` plants windowed
    attention in the port's transformer."""
    model = model_of(weights, **cfg)
    config = model.config
    g = torch.Generator().manual_seed(seed)
    N, M = config.total_points, config.global_points
    src = torch.rand((1, N, 3), generator=g) * 2 - 1
    cond = torch.rand((1, N, 3), generator=g) * 2 - 1
    draws = dict(x_init=torch.randn((1, N, 3), generator=g),
                 cond_priority=torch.rand((1, N), generator=g),
                 step_priorities=torch.rand((steps, 1, N), generator=g),
                 fps_starts=torch.stack([torch.randint(0, M, (1,)),
                                         torch.randint(0, 512, (1,))]))
    attention = transformer.attention
    if window:
        def windowed(qkv, heads):
            return torch.cat([attention(c, heads)
                              for c in qkv.split(window, dim=1)], dim=1)
        transformer.attention = windowed
    try:
        got = guided_sample_loop(model, make_schedule(config), src, cond,
                                 num_inference_steps=steps,
                                 guidance_scale=7.5, **draws)[0]
    finally:
        transformer.attention = attention
    cfg_dict = bench_cfg(total_points=N, global_points=M)
    ref_draws = {k: v[:, 0] if k in ("step_priorities", "fps_starts")
                 else v[0] for k, v in draws.items()}
    want = guided_transfer(weights, cfg_dict, src[0], cond[0], ref_draws,
                           steps, 7.5, True, net=ref_of(weights))
    return got, want


def test_guided_sampler_matches_reference(weights):
    """The hierarchical sampler (voxel downsample to 256, the transformer
    on [cond; uncond], k = 3 upsample of the other 1,792, DDIM) against
    ``guided_transfer`` with the reference's network, same draws, 10 steps
    at guidance 7.5 in float32: the median point within 1e-6, every point
    within 1e-3 (an interpolated point beside a coarse one weighs it by
    1 / (d + 1e-8), and the guidance scales float32's last bits by 7.5)."""
    got, want = sampler_pair(weights)
    assert got.shape == want.shape == (2048, 3)
    err = (got - want).norm(dim=1)
    assert float(err.median()) <= 1e-6
    assert float(err.max()) <= 1e-3


def test_windowed_attention_fails_the_sampler_comparison(weights):
    """The planted fault of the card's check, at this size: attention
    restricted to windows of 64 tokens in token order (the card's 1,024 of
    4,098) moves the median point past 1e-3, a thousand times the sound
    run's bound."""
    got, want = sampler_pair(weights, window=64)
    err = (got - want).norm(dim=1)
    assert float(err.median()) > 1e-3


def plant_choice_fault(fault):
    """Plants a fault of the sampler's discrete choices in the program and
    returns its undo: ``knn4`` takes every 32nd query row's fourth nearest
    coarse point as its third neighbour; ``voxel`` swaps every 32nd
    representative of the downsample for a point of the rest."""
    from pointcloud_style_transfer_torch.models import samplers
    from pointcloud_style_transfer_torch.ops import grid_knn
    if fault == "knn4":
        module, name = grid_knn, "knn_topk"
        orig = grid_knn.knn_topk

        def faulty(q, r, k, **kw):
            d, i = orig(q, r, k + 1, **kw)
            rows = (torch.arange(d.shape[1]) % 32 == 0)[None, :, None]
            return tuple(torch.where(rows, torch.cat(
                [t[..., :2], t[..., 3:4]], -1), t[..., :k]) for t in (d, i))
    else:
        module, name = samplers, "voxel_order"
        orig = samplers.voxel_order

        def faulty(points, M, *args, **kwargs):
            order = orig(points, M, *args, **kwargs).clone()
            j = torch.arange(0, M // 32) * 32
            order[:, j], order[:, M + j] = order[:, M + j], order[:, j]
            return order
    setattr(module, name, faulty)
    return lambda: setattr(module, name, orig)


@pytest.mark.parametrize("fault", [None, "knn4", "voxel"])
def test_choice_misses_see_a_wrong_choice(weights, fault):
    """The benchmark's audit of the choices its reference is pinned to
    (``h100_bench/reference/point_e.py::choice_misses``), on the points
    the port's sampler recorded at each step: a sound run's voxel orders
    and neighbours miss nothing; a planted wrong third neighbour on every
    32nd row, or a wrong representative in every 32nd place, is counted at
    each step, row for row."""
    steps = 4
    model = model_of(weights)
    N, M = model.config.total_points, model.config.global_points
    g = torch.Generator().manual_seed(5)
    src, cond = (torch.rand((1, N, 3), generator=g) * 2 - 1 for _ in "ab")
    prio = torch.rand((steps, 1, N), generator=g)
    undo = plant_choice_fault(fault) if fault else (lambda: None)
    sel: dict = {}
    try:
        guided_sample_loop(model, make_schedule(model.config), src, cond,
                           num_inference_steps=steps, guidance_scale=7.5,
                           selections=sel, generator=g,
                           step_priorities=prio)
    finally:
        undo()
    misses = [bench_point_e.choice_misses(
        sel[f"step{s}.voxel.points"][0], prio[s, 0], M,
        sel[f"step{s}.voxel"][0], sel[f"step{s}.knn"][0])
        for s in range(steps)]
    rows = -(-(N - M) // 32)
    want = {None: (0, 0), "knn4": (0, rows), "voxel": (M // 32, 0)}[fault]
    for voxel, knn in misses:
        assert voxel == want[0]
        if fault == "knn4":  # a fourth nearest tied with the third is right
            assert rows - 2 <= knn <= rows
        else:
            assert knn == want[1]


def test_direct_sampler_runs(weights):
    model = model_of(weights, total_points=256)
    g = torch.Generator().manual_seed(0)
    out = guided_sample_loop(model, make_schedule(model.config),
                             torch.rand((1, 256, 3)), torch.rand((1, 256, 3)),
                             num_inference_steps=2, use_hierarchical=False,
                             generator=g)
    assert out.shape == (1, 256, 3) and torch.isfinite(out).all()


def test_train_step_matches_reference_autograd(weights):
    """Three mini-steps of ``train_step`` (one optimizer step, accumulation
    3) against the reference's losses and autograd at the same weights
    and draws: each loss within 1e-5 relative, and the clipped mean
    gradient the optimizer holds (its first moment over 1 - b1) within
    1e-3 relative by each leaf's norm and 1e-4 in total (float32 sums in
    another order, through BatchNorm's batch statistics and the Chamfer's
    argmins)."""
    from pointcloud_style_transfer_torch.training.trainer import (
        compute_losses, make_optimizer, step_draws, train_step)
    from pointcloud_style_transfer_torch.training.ema import ema_init
    model = model_of(weights, total_points=512, global_points=128)
    cfg = model.config
    schedule = make_schedule(cfg)
    params = dict(model.net.named_parameters())
    opt = make_optimizer(cfg, params)
    ema = ema_init(params)
    start = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    g = torch.Generator().manual_seed(5)
    batches, losses = [], []
    for _ in range(cfg.gradient_accumulation_steps):
        sim = torch.rand((2, 512, 3), generator=g) * 2 - 1
        real = torch.rand((2, 512, 3), generator=g) * 2 - 1
        draws = step_draws(model, 2, 512, 512, train=True, generator=g)
        assert "noise_dropout_masks" not in draws
        terms, _ = train_step(model, schedule, opt, ema, sim, real, 1e-4,
                              draws=draws)
        batches.append((sim, real, draws))
        losses.append(float(terms["total_loss"]))
    grad = {n: m / (1 - opt.b1) for n, m in zip(opt.names,
                                                opt._unflat(opt.mu))}
    w = {k: v.clone() for k, v in start.items()
         if not k.endswith("num_batches_tracked")}
    names = list(opt.names)
    acc = {k: torch.zeros_like(w[k]) for k in names}
    for (sim, real, draws), got_loss in zip(batches, losses):
        leaves = {k: w[k].clone().requires_grad_(True) for k in names}
        net = ref_of({**w, **leaves})
        loss = train_losses(net, cfg, sim, real, draws)
        assert abs(loss.item() - got_loss) <= 1e-5 * abs(loss.item())
        for k, gr in zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])):
            acc[k] += gr / len(batches)
        for k in w:  # BatchNorm's running statistics move in train mode
            if k.endswith(("running_mean", "running_var")):
                w[k] = net.encoder.w[k].detach()
    norm = torch.sqrt(sum((a * a).sum() for a in acc.values()))
    scale = min(1.0, cfg.gradient_clip / float(norm))
    # a bias before a train-mode BatchNorm has a gradient that is nought
    # up to rounding (the mean the normalisation takes out): each leaf is
    # held against the larger of its norm and a thousandth of the median's
    floor = 1e-3 * float(np.median([float(a.norm()) for a in acc.values()]))
    total_err = total = 0.0
    for k in names:
        want = acc[k] * scale
        err = float((grad[k] - want).norm())
        assert err <= 1e-3 * max(float(want.norm()), floor), k
        total_err, total = total_err + err ** 2, total + float(
            want.norm()) ** 2
    assert total_err ** 0.5 <= 1e-4 * total ** 0.5
    with pytest.raises(ValueError, match="selections"):
        compute_losses(model, schedule, *batches[0][:2], train=True,
                       cond_drop_prob=0.1, chamfer_weight=0.1,
                       draws={**batches[0][2], "selections": {}})


def test_guards(weights):
    model = model_of(weights)
    x, t, style = inputs()
    with pytest.raises(ValueError, match="selections"):
        model.net.predict_noise(x, t, style, selections={})
    with pytest.raises(ValueError, match="dropout"):
        model.net.predict_noise(x, t, style, True, [torch.ones(2, 256, F)])
    with pytest.raises(ValueError, match="mixes points"):
        guided_sample_loop(model, make_schedule(model.config),
                           torch.rand((1, 2048, 3)), torch.rand((1, 2048, 3)),
                           num_inference_steps=2, mesh=object())
    from pointcloud_style_transfer_torch.parallel.sharded import StepLayout
    layout = StepLayout.__new__(StepLayout)
    layout.p = 2
    with pytest.raises(ValueError, match="mixes points"):
        layout.predict_noise(model.net)
    with pytest.raises(ValueError, match="style width"):
        DiffusionNet(64, denoiser=SPEC)


def test_trainer_runs_the_transformer_without_dropout(tmp_path):
    from pointcloud_style_transfer_torch.training import DiffusionTrainer
    cfg = Config(**{**SMALL, "total_points": 512, "global_points": 128},
                 **{f"{d}_dir": str(tmp_path / d) for d in (
                     "checkpoint", "log", "result", "processed_data")})
    trainer = DiffusionTrainer(cfg, resume=False, device="cpu",
                               denoiser=SPEC)
    assert isinstance(trainer.model.net.noise_predictor,
                      transformer.PointETransformer)
    sim = torch.rand((2, 512, 3)) * 2 - 1
    terms, emit = trainer.train_step(sim, sim.flip(1), 1e-4)
    assert torch.isfinite(terms["total_loss"]) and not bool(emit)
    trainer.checkpoint_manager.save(trainer.state(), 0, cfg,
                                    denoiser=trainer.model.denoiser)
    from pointcloud_style_transfer_torch.utils.checkpoint import (
        load_for_inference)
    _, model = load_for_inference(trainer.checkpoint_manager.epoch_dir(0),
                                  "cpu")
    assert model.denoiser == SPEC


def test_checkpoint_round_trip_and_cli_inference(weights, tmp_path):
    from pointcloud_style_transfer_torch.cli import inference
    from pointcloud_style_transfer_torch.utils.checkpoint import (
        CheckpointManager, load_for_inference, save_checkpoint,
        split_state_dict)
    model = model_of(weights, total_points=600)
    params, stats = split_state_dict(model.net)
    path = save_checkpoint(str(tmp_path / "model.pt"), model.config, params,
                           stats, denoiser=SPEC)
    manager = CheckpointManager(str(tmp_path / "dirs"), "exp")
    saved = manager.save({"params": params, "batch_stats": stats,
                          "ema_params": params}, 3, model.config,
                         denoiser=SPEC)
    x, t, style = inputs(6)
    want = model.predict_noise(x, t, style)
    for p in (path, saved):
        config, loaded = load_for_inference(p, "cpu")
        assert loaded.denoiser == SPEC and config == model.config
        assert isinstance(loaded.net.noise_predictor,
                          transformer.PointETransformer)
        assert torch.equal(loaded.predict_noise(x, t, style), want)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "src.npy", rng.standard_normal((600, 3)) * 10)
    np.save(tmp_path / "ref.npy", rng.standard_normal((700, 3)) * 10)
    out = tmp_path / "out.npy"
    assert inference.main(["--checkpoint", path, "--source",
                           str(tmp_path / "src.npy"), "--reference",
                           str(tmp_path / "ref.npy"), "--output", str(out),
                           "--num_steps", "2", "--device", "cpu"]) == 0
    res = np.load(out)
    assert res.shape == (600, 3) and np.isfinite(res).all()


@pytest.mark.parametrize("name", ["mlp", "point-e-base40M",
                                  "point-e-base300M", "point-e-base1B"])
def test_cli_train_denoiser_choices(name):
    from pointcloud_style_transfer_torch.cli import train
    assert name in train.DENOISERS
    spec = train.denoiser_of(name)
    if name == "mlp":
        assert spec is None
    else:
        assert spec == PRESETS[name.split("-")[-1]]
