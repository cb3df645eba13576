"""Fast-mode fidelity of the PyTorch port with trained weights: the
counterpart of ``examples/fast_mode_fidelity.py``.

Loads the training proof's best checkpoint
(``examples/e2e_training_proof_torch.py``), runs the per-step sampler
(``guided_sample_loop``) and the coarse displacement-field one
(``guided_sample_loop_coarse``, ``--fast``) from the same seed (100 + i
for val pair i) on held-out val pairs, and reports the Chamfer distance
between their outputs beside the distances to the input clouds as scale
references. Writes ``fidelity.json`` to ``--outdir``:

    python examples/fast_mode_fidelity_torch.py \\
        --workdir build/e2e_proof_torch \\
        --outdir docs/artifacts/e2e_training_torch [--device cpu]

``main`` returns the payload written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from pointcloud_style_transfer_torch.ops import chamfer_distance  # noqa: E402


def mean_chamfer(a: torch.Tensor, b: torch.Tensor) -> float:
    """The batch mean of the squared-L2 Chamfer distance (the training
    loss's, ``ops.chamfer_distance``)."""
    return float(chamfer_distance(a, b).mean())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default="build/e2e_proof_torch")
    parser.add_argument("--outdir",
                        default="docs/artifacts/e2e_training_torch")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from pointcloud_style_transfer_torch.data import \
        HierarchicalPointCloudDataset
    from pointcloud_style_transfer_torch.models import (
        guided_sample_loop, guided_sample_loop_coarse, make_schedule)
    from pointcloud_style_transfer_torch.utils.checkpoint import \
        load_for_inference

    ckpt = f"{args.workdir}/checkpoints/e2e_proof/best_model"
    config, model = load_for_inference(ckpt, args.device)
    device = model.device
    schedule = make_schedule(config).to(device)
    ds = HierarchicalPointCloudDataset(f"{args.workdir}/processed/val",
                                       use_hierarchical=True)
    rows = []
    for i in range(min(args.pairs, len(ds.file_paths))):
        item = ds[i]
        src = torch.from_numpy(item["sim_full"])[None].to(device)
        cond = torch.from_numpy(item["real_full"])[None].to(device)
        parity, fast = (sampler(
            model, schedule, src, cond,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=config.guidance_scale,
            generator=torch.Generator(device=device).manual_seed(100 + i))
            for sampler in (guided_sample_loop, guided_sample_loop_coarse))
        rows.append({"pair": i,
                     "cd_fast_parity": mean_chamfer(fast, parity),
                     "cd_parity_source": mean_chamfer(parity, src),
                     "cd_parity_style": mean_chamfer(parity, cond)})
        print(f"pair {i}: CD(fast, parity)={rows[-1]['cd_fast_parity']:.5f}"
              f"  CD(parity, source)={rows[-1]['cd_parity_source']:.4f}  "
              f"CD(parity, style)={rows[-1]['cd_parity_style']:.4f}",
              flush=True)
    means = {k: float(np.mean([r[k] for r in rows]))
             for k in ("cd_fast_parity", "cd_parity_source",
                       "cd_parity_style")}
    print(f"\nmean CD(fast, parity) = {means['cd_fast_parity']:.5f} "
          f"(vs {means['cd_parity_source']:.3f} / "
          f"{means['cd_parity_style']:.3f} to inputs)")
    payload = {"checkpoint": ckpt,
               "num_inference_steps": args.num_inference_steps,
               "rows": rows, "mean": means}
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "fidelity.json"), "w") as f:
        json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    main()
