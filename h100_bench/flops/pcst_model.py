"""Model FLOPs of the style-transfer network, counted from a configuration's
widths (``core.model_spec``): two FLOPs a multiply-add of every dense
layer, nothing else (BatchNorm, activations, pooling, the DDIM update and
the kNN are left out, so a share of the peak is the model's, not the
program's)."""

from __future__ import annotations

from ..core import model_spec


def denoiser_macs_per_point(cfg: dict) -> int:
    return sum(i * o for _, i, o in model_spec.denoiser_point_layers(cfg))


def denoiser_macs_per_cloud(cfg: dict) -> int:
    """The time and style projections, once a cloud and step."""
    return sum(i * o for _, i, o in model_spec.denoiser_cloud_layers(cfg))


def encoder_macs(cfg: dict) -> int:
    """One cloud through the style encoder: each set abstraction's shared
    MLP on its centres x neighbours (group-all: on every point of the
    level below), then the head."""
    layers = dict((n, (i, o)) for n, i, o in model_spec.encoder_layers(cfg))
    macs, below = 0, None
    for s, (npoint, _, nsample, mlp) in enumerate(cfg["set_abstractions"]):
        rows = npoint * nsample if npoint else below
        for j in range(len(mlp)):
            i, o = layers[f"style_encoder.encoder.sa{s + 1}.linears.{j}"]
            macs += rows * i * o
        below = npoint
    for name in ("style_encoder.fc1", "style_encoder.fc2"):
        i, o = layers[name]
        macs += i * o
    return macs


def serve_flops_per_cloud(cfg: dict, steps: int, hierarchical: bool) -> int:
    """One cloud through ``guided_sample_loop``: the style encoder once,
    then each step the denoiser on the conditioned and unconditioned copies
    of the rows it sees (the voxel downsample, or every point)."""
    rows = cfg["global_points"] if hierarchical else cfg["total_points"]
    per_step = 2 * (rows * denoiser_macs_per_point(cfg)
                    + denoiser_macs_per_cloud(cfg))
    return 2 * (encoder_macs(cfg) + steps * per_step)


def train_forward_flops(cfg: dict, batch: int, hierarchical: bool) -> int:
    """One training mini-step's forward: the encoder on each reference
    cloud's downsample and the denoiser on each noised cloud's."""
    rows = cfg["global_points"] if hierarchical else cfg["total_points"]
    return 2 * batch * (encoder_macs(cfg) + rows * denoiser_macs_per_point(
        cfg) + denoiser_macs_per_cloud(cfg))
