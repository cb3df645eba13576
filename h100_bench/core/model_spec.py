"""The network's tensors, by name and shape, worked out from a
configuration's widths: what the benchmark fills with seeded weights, what
the reference reads, and what the FLOP counts of ``flops/`` walk."""

from __future__ import annotations

from typing import Dict, List, Tuple

Shapes = Dict[str, Tuple[int, ...]]


def encoder_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every 1x1 layer of the style encoder, in order."""
    layers, chans = [], 0
    for i, (npoint, _, _, mlp) in enumerate(cfg["set_abstractions"]):
        c_in = 3 + chans
        for j, c_out in enumerate(mlp):
            layers.append((f"style_encoder.encoder.sa{i + 1}.linears.{j}",
                           c_in, c_out))
            c_in = c_out
        chans = mlp[-1]
    head = cfg["style_head"]
    layers.append(("style_encoder.fc1", chans, head[0]))
    layers.append(("style_encoder.fc2", head[0], head[1]))
    return layers


def denoiser_point_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every layer the denoiser runs on each point."""
    F = cfg["feature_dim"]
    p = "noise_predictor"
    layers = [(f"{p}.point_encoder.0", 3, 128),
              (f"{p}.point_encoder.1", 128, 256),
              (f"{p}.point_encoder.2", 256, F)]
    for i in range(cfg["denoiser_blocks"]):
        layers += [(f"{p}.blocks.{i}.0", F, 2 * F),
                   (f"{p}.blocks.{i}.1", 2 * F, F)]
    layers += [(f"{p}.output_mlp.0", F, 256), (f"{p}.output_mlp.1", 256, 128),
               (f"{p}.output_mlp.2", 128, 3)]
    return layers


def denoiser_cloud_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of the denoiser's layers run once a cloud."""
    F = cfg["feature_dim"]
    return [("noise_predictor.time_proj", cfg["time_embed_dim"], F),
            ("noise_predictor.style_proj", F, F)]


def batchnorm_layers(cfg: dict) -> List[Tuple[str, int]]:
    out = []
    for i, (_, _, _, mlp) in enumerate(cfg["set_abstractions"]):
        out += [(f"style_encoder.encoder.sa{i + 1}.bns.{j}", c)
                for j, c in enumerate(mlp)]
    return out


def shapes(cfg: dict) -> Shapes:
    """Every parameter and BatchNorm statistic: name -> shape."""
    out: Shapes = {}
    for name, c_in, c_out in (encoder_layers(cfg) + denoiser_point_layers(cfg)
                              + denoiser_cloud_layers(cfg)):
        out[f"{name}.weight"] = (c_out, c_in)
        out[f"{name}.bias"] = (c_out,)
    for name, c in batchnorm_layers(cfg):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)
    return out


def parameter_count(cfg: dict) -> int:
    """Trainable parameters: every tensor but the running statistics."""
    n = 0
    for name, shape in shapes(cfg).items():
        if not name.endswith(("running_mean", "running_var")):
            size = 1
            for s in shape:
                size *= s
            n += size
    return n
