"""Stage costs of the StyleEncoder forward on the PyTorch port: the
counterpart of ``examples/profile_style_encoder.py`` (the fused
SetAbstraction kernel decision: how much of the encoder the grouping and
the per-point MLP with its max-pool cost at all, beside the FPS and
ball-query kernels that carry the selection).

The encoder runs on the sampler's input, the downsampled condition cloud
(``Config().global_points``, B = 1), with ``Config()``'s widths. Each stage
runs ``--chain`` times (50) in one body; on the card the body is one CUDA
graph (``models/capture.py``) replayed ``--reps`` times (5) between CUDA
events. Stages, per SetAbstraction (sa1: 512 centres, radius 0.2, 32
neighbours; sa2: 128, 0.4, 64):

  <sa>.fps         farthest point sampling (the ``fps`` kernel);
  <sa>.ball_query  the ball query (the ``ball_query`` kernel);
  <sa>.group       the neighbours' gather, centring and feature concat;
  <sa>.mlp_pool    Dense + BatchNorm + ReLU x 3 and the max-pool;
  sa3.group_all    sa3's concat, its MLP and the pool over every point;
  selection        FPS + ball query + gather of both stages (what a fused
                   kernel cannot remove);
  encoder          ``PointNet2Encoder`` (all three stages);
  full             ``StyleEncoder`` (the encoder and its MLP head).

Derived as the JAX script prints them: ``head`` = encoder - selection (the
grouped MLP + pool, at most what a fused SetAbstraction kernel removes)
and ``mlp_head`` = full - encoder (the Dense 256->512->256 head).

Usage: python examples/profile_style_encoder_torch.py [--chain 50]
           [--reps 5] [--device cuda|cpu] [--config FIELD=VALUE ...]
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.models import capture  # noqa: E402
from pointcloud_style_transfer_torch.ops import (  # noqa: E402
    farthest_point_sample, index_points, query_ball_point)


def mlp_pool(sa, grouped: torch.Tensor) -> torch.Tensor:
    """``SetAbstraction.forward`` after the grouping, in eval mode."""
    x = grouped
    for lin, bn in zip(sa.linears, sa.bns):
        x = F.relu(bn(lin(x)))
    return x.max(dim=2).values


def stage_fns(model, pts: torch.Tensor, fps_starts: torch.Tensor) -> dict:
    """Each stage as a call on the inputs the stages before it made."""
    style = model.net.style_encoder
    enc = style.encoder
    kern = enc.sa1.use_kernels
    s1, s2 = fps_starts

    def fps(xyz, sa, start):
        return farthest_point_sample(xyz, sa.npoint, start=start,
                                     use_kernel=kern)

    def ball(xyz, centres, sa):
        return query_ball_point(sa.radius, sa.nsample, xyz, centres,
                                use_kernel=kern)

    def group(xyz, feats, centres, idx):
        g = index_points(xyz, idx) - centres[:, :, None, :]
        return g if feats is None else torch.cat(
            [g, index_points(feats, idx)], dim=-1)

    # the intermediates, once
    c1 = fps(pts, enc.sa1, s1)
    xyz1 = index_points(pts, c1)
    g1 = ball(pts, xyz1, enc.sa1)
    grouped1 = group(pts, None, xyz1, g1)
    feats1 = mlp_pool(enc.sa1, grouped1)
    c2 = fps(xyz1, enc.sa2, s2)
    xyz2 = index_points(xyz1, c2)
    g2 = ball(xyz1, xyz2, enc.sa2)
    grouped2 = group(xyz1, feats1, xyz2, g2)
    feats2 = mlp_pool(enc.sa2, grouped2)

    def selection():
        a = fps(pts, enc.sa1, s1)
        x1 = index_points(pts, a)
        gr1 = group(pts, None, x1, ball(pts, x1, enc.sa1))
        b = fps(x1, enc.sa2, s2)
        x2 = index_points(x1, b)
        gr2 = group(x1, None, x2, ball(x1, x2, enc.sa2))
        return gr1.sum() + gr2.sum()
    return {
        "sa1.fps": lambda: fps(pts, enc.sa1, s1),
        "sa1.ball_query": lambda: ball(pts, xyz1, enc.sa1),
        "sa1.group": lambda: group(pts, None, xyz1, g1),
        "sa1.mlp_pool": lambda: mlp_pool(enc.sa1, grouped1),
        "sa2.fps": lambda: fps(xyz1, enc.sa2, s2),
        "sa2.ball_query": lambda: ball(xyz1, xyz2, enc.sa2),
        "sa2.group": lambda: group(xyz1, feats1, xyz2, g2),
        "sa2.mlp_pool": lambda: mlp_pool(enc.sa2, grouped2),
        "sa3.group_all": lambda: enc.sa3(xyz2, feats2)[1],
        "selection": selection,
        "encoder": lambda: enc(pts, fps_starts),
        "full": lambda: style(pts, fps_starts),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chain", type=int, default=50)
    parser.add_argument("--reps", type=int, default=5)
    common.script_args(parser)
    args = parser.parse_args(argv)
    model = common.random_model(args.device, common.config_of(args))
    device, cfg = model.device, model.config
    M = cfg.global_points
    gen = torch.Generator(device=device).manual_seed(common.SEED)
    pts = torch.randn((1, M, 3), generator=gen, device=device)
    fps_starts = model.net.style_encoder.encoder.draw_fps_starts(
        M, 1, gen, device)
    card = common.device_name(device)
    print(f"device={card} points={M} chain={args.chain} reps={args.reps}",
          flush=True)
    readings = {}
    with torch.no_grad():
        for name, fn in stage_fns(model, pts, fps_starts).items():
            capture.release()

            def body(ins, fn=fn):
                return [fn() for _ in range(args.chain)][-1]
            run = functools.partial(
                common.run_body, ("style_encoder", name, args.chain,
                                  capture.model_key(model)),
                body, {"points": pts}, model.net, device)
            res = common.measure(run, args.reps, device)
            if not torch.isfinite(res["first"].float()).all():
                raise RuntimeError(f"{name}: output not finite")
            per = [ms / args.chain for ms in res["ms"]]
            readings[name] = {"ms": statistics.median(per),
                              "spread": common.spread(per),
                              "launches": {k: n / args.chain for k, n in
                                           res["launches"].items()}}
            print(f"{name:16s} {readings[name]['ms']:8.4f} ms/call (spread "
                  f"{100 * readings[name]['spread']:.1f}%) launches/call "
                  f"{readings[name]['launches']}", flush=True)
    capture.release()
    ms = {n: r["ms"] for n, r in readings.items()}
    derived = {"head": ms["encoder"] - ms["selection"],
               "mlp_head": ms["full"] - ms["encoder"]}
    print(f"{'head':16s} {derived['head']:8.4f} ms/call  (grouped MLP + pool: "
          "at most what a fused SetAbstraction kernel removes)")
    print(f"{'mlp_head':16s} {derived['mlp_head']:8.4f} ms/call  (Dense "
          "256->512->256 head, not SetAbstraction)")
    return {"device": card, "points": M, "chain": args.chain,
            "stages": readings, "derived": derived}


if __name__ == "__main__":
    main()
