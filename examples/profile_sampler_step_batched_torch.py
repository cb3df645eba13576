"""In-context attribution of the BATCHED sampling step on the PyTorch port:
the counterpart of ``examples/profile_sampler_step_batched.py``.

The same stub method and step body as ``profile_sampler_step_torch.py``
(the B = 1 tool), at B clouds: at B > 1 the upsample is the production
step's ``samplers._upsample_unknown``, the flat-batched grid (one build,
one ``grid_interp`` launch and one fallback ladder for the batch), so B > 1
marginals are measured where the batch shares those launches. Each
variant's ``--steps`` steps (10) are one CUDA graph on the card, keyed by
the variant and B, replayed ``--reps`` times (10) between CUDA events, in
alternation with a ``full`` graph beside it; a marginal within the spread
of either reading is printed as unresolved. Variants: full, noup (the
upsample and the assembly dropped: the coarse noise and a scaled copy of
the unknown points concatenated; the JAX script's mean broadcast costs
more on the card), novoxel, nodenoise, noddim.

Usage: python examples/profile_sampler_step_batched_torch.py [B ...]
           [variant ...] [--steps 10] [--reps 10] [--device cuda|cpu]
           [--config FIELD=VALUE ...]
(B defaults to 1 2 4; the JAX script's default is 1 4.)
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
import profile_sampler_step_torch as step_tool  # noqa: E402
from pointcloud_style_transfer_torch.models import make_schedule  # noqa: E402

VARIANTS = ("full", "noup", "novoxel", "nodenoise", "noddim")
# a step's launches at any B (step_tool.LAUNCHES): one flat-batched
# interpolation and one counted patch launch for the batch (a group of up
# to 8 clouds)
LAUNCHES = {v: step_tool.LAUNCHES[v] for v in VARIANTS}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*",
                        help="batch sizes and variants, in any order")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--reps", type=int, default=10)
    common.script_args(parser)
    args = parser.parse_args(argv)
    batches = [int(a) for a in args.args if a.isdigit()] or [1, 2, 4]
    variants = [a for a in args.args if not a.isdigit()] or list(VARIANTS)
    bad = set(variants) - set(VARIANTS)
    if bad:
        parser.error(f"unknown variants {sorted(bad)}; choose from {VARIANTS}")

    model = common.random_model(args.device, common.config_of(args))
    device, cfg = model.device, model.config
    N, M = cfg.total_points, cfg.global_points
    schedule = make_schedule(cfg).to(device)
    card = common.device_name(device)
    print(f"device={card} N={N} M={M} steps={args.steps} reps={args.reps}",
          flush=True)
    readings: dict = {}
    for B in batches:
        gen = torch.Generator(device=device).manual_seed(common.SEED + 3)
        inputs = step_tool.sampler_inputs(model, B, args.steps, gen)
        res = step_tool.run_variants(
            model, variants, args.steps, args.reps, inputs, schedule, None,
            cfg.guidance_scale, ("profile_sampler_step_batched", B))
        by_variant = readings[B] = {}
        for variant in variants:
            step_tool.check_variant(variant, res[variant], args.steps,
                                    (B, N, 3), device,
                                    common.denoiser_launches(model))
            r = by_variant[variant] = step_tool.readings_of(res[variant],
                                                            args.steps)
            r["ms_per_cloud_step"] = r["ms_per_step"] / B
            line = (f"B={B} {variant}: {r['ms_per_step']:.4f} ms/step "
                    f"({r['ms_per_cloud_step']:.4f} ms/cloud-step, spread "
                    f"{100 * r['spread']:.1f}%)")
            if r["marginal"] is not None:
                line += ("  marginal "
                         + common.marginal_note(r["marginal"]) + "/step")
            print(line, flush=True)
    return {"device": card, "N": N, "M": M, "steps": args.steps,
            "by_batch": readings}


if __name__ == "__main__":
    main()
