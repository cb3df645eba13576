"""The train-loss spike mechanism of the PyTorch port: the Chamfer term
against the timestep (the counterpart of ``examples/loss_spike_analysis.py``).

The training loss (``training/trainer.py::compute_losses``) adds 0.1 x
Chamfer(pred_x0, x0_coarse), where pred_x0 = (noisy - b * pred_noise) / a
with a = sqrt(alpha_bar_t), b = sqrt(1 - alpha_bar_t). As t -> T the
amplification b/a grows past 3e3 on the cosine schedule, so a batch that
samples a large t makes a Chamfer term orders of magnitude above the mean
even at a fixed, trained parameter point. The L1 term and the (L1-only)
validation loss are the convergence signals.

On a fixed validation batch, at t = 0, t_step, 2 t_step, ... and T - 1,
``terms_at_t`` computes the L1 term, the Chamfer term and b/a exactly as
``compute_losses`` does in eval mode (no dropout, no condition drop), under
the checkpoint's EMA weights; row i's draws come from a generator seeded
100 + i. Writes ``spike_analysis.json`` (and ``.png`` where matplotlib
imports) to ``--outdir``:

    python examples/loss_spike_analysis_torch.py \\
        --checkpoint build/e2e_proof_torch/checkpoints/e2e_proof/best_model \\
        --data build/e2e_proof_torch/processed/val \\
        --outdir docs/artifacts/e2e_training_torch [--device cpu]

``main`` returns the payload written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Tuple

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from pointcloud_style_transfer_torch.models import q_sample  # noqa: E402
from pointcloud_style_transfer_torch.models.losses import \
    diffusion_loss  # noqa: E402
from pointcloud_style_transfer_torch.ops import index_points  # noqa: E402


@torch.no_grad()
def terms_at_t(model, schedule, sim: torch.Tensor, real: torch.Tensor,
               t: int, noise: torch.Tensor, draws: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L1, Chamfer(pred_x0), b/a) at timestep ``t`` for every cloud of the
    batch, as ``compute_losses`` computes the terms in eval mode. ``noise``
    [B, N, 3] is the q_sample noise; ``draws`` holds the forward's
    (``cond_priority``, ``fps_starts``, ``noisy_priority``)."""
    cfg = model.config
    B = sim.shape[0]
    tt = torch.full((B,), t, dtype=torch.long, device=sim.device)
    noisy = q_sample(schedule, sim, tt, noise)
    pred, idx, _ = model.forward(
        noisy, tt, real, cond_drop_prob=0.0,
        use_hierarchical=cfg.use_hierarchical, train=False, **draws)
    noisy_coarse = index_points(noisy, idx)
    sim_coarse = index_points(sim, idx)
    noise_coarse = index_points(noise, idx)
    a = schedule.sqrt_alphas_cumprod[tt][:, None, None]
    b = schedule.sqrt_one_minus_alphas_cumprod[tt][:, None, None]
    pred_x0 = (noisy_coarse - b * pred.float()) / (a + 1e-8)
    _, loss_dict = diffusion_loss(
        pred, noise_coarse, pred_x0, sim_coarse,
        chamfer_weight=cfg.lambda_chamfer,
        backend="pallas" if cfg.use_pallas else "jnp")
    amp = (schedule.sqrt_one_minus_alphas_cumprod[t]
           / schedule.sqrt_alphas_cumprod[t])
    return loss_dict["noise_loss"], loss_dict["chamfer_loss"], amp


def timesteps(num_timesteps: int, t_step: int) -> list:
    ts = list(range(0, num_timesteps, t_step))
    if ts[-1] != num_timesteps - 1:
        ts.append(num_timesteps - 1)
    return ts


def plot_rows(rows: list, path: str) -> bool:
    """The terms against t as a PNG; False where matplotlib does not
    import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(7, 4))
    t_arr = [r["t"] for r in rows]
    ax.plot(t_arr, [r["l1"] for r in rows], "o-", label="L1 (noise)")
    ax.plot(t_arr, [r["chamfer"] for r in rows], "s-",
            label="Chamfer(pred_x0)")
    ax.plot(t_arr, [r["amplification_b_over_a"] ** 2 for r in rows], "--",
            label="(b/a)^2 (amplification)")
    ax.set_xlabel("timestep t")
    ax.set_yscale("log")
    ax.legend()
    ax.set_title("loss terms vs t at a fixed trained parameter point")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", default="build/e2e_proof_torch/"
                        "checkpoints/e2e_proof/best_model")
    parser.add_argument("--data",
                        default="build/e2e_proof_torch/processed/val")
    parser.add_argument("--outdir",
                        default="docs/artifacts/e2e_training_torch")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--t_step", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from pointcloud_style_transfer_torch.data import (
        Batcher, HierarchicalPointCloudDataset)
    from pointcloud_style_transfer_torch.models import make_schedule
    from pointcloud_style_transfer_torch.training.trainer import step_draws
    from pointcloud_style_transfer_torch.utils.checkpoint import \
        load_for_inference

    config, model = load_for_inference(args.checkpoint, args.device)
    device = model.device
    schedule = make_schedule(config).to(device)
    ds = HierarchicalPointCloudDataset(
        args.data, use_hierarchical=config.use_hierarchical)
    loader = Batcher(ds, batch_size=min(args.batch, len(ds)), shuffle=False,
                     drop_last=False)
    batch = next(iter(loader))
    sim = torch.from_numpy(batch["sim_full"]).to(device)
    real = torch.from_numpy(batch["real_full"]).to(device)

    rows = []
    for i, t in enumerate(timesteps(config.num_timesteps, args.t_step)):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        draws = step_draws(model, sim.shape[0], sim.shape[1], real.shape[1],
                           train=False, cond_drop_prob=0.0, generator=gen,
                           device=device, given={"t": None})
        l1, cd, amp = terms_at_t(model, schedule, sim, real, t,
                                 draws.pop("noise"), draws)
        rows.append({"t": int(t), "l1": float(l1), "chamfer": float(cd),
                     "amplification_b_over_a": float(amp)})
        print(f"t={t:4d}  L1={rows[-1]['l1']:.4f}  "
              f"Chamfer(pred_x0)={rows[-1]['chamfer']:.4g}  "
              f"b/a={rows[-1]['amplification_b_over_a']:.4g}", flush=True)

    os.makedirs(args.outdir, exist_ok=True)
    payload = {
        "explanation": (
            "Chamfer(pred_x0, x0) with pred_x0 = (noisy - b*pred)/a "
            "amplifies prediction error by (b/a)(t); batches sampling "
            "large t therefore spike the train total while the L1 term "
            "stays flat (training/trainer.py::compute_losses)."),
        "checkpoint": args.checkpoint,
        "rows": rows,
    }
    with open(os.path.join(args.outdir, "spike_analysis.json"), "w") as f:
        json.dump(payload, f, indent=2)
    plot_rows(rows, os.path.join(args.outdir, "spike_analysis.png"))
    print(f"done - {args.outdir}/spike_analysis.json")
    return payload


if __name__ == "__main__":
    main()
