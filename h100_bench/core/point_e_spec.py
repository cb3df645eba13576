"""Point-E's transformer denoiser (the configuration file's ``denoiser``
entry) by name and shape, and the seeded weights of a configuration that
runs it: what the benchmark fills, the reference reads and
``flops/point_e.py`` walks. The style encoder's tensors are
``core.model_spec``'s.

The weights are made as ``core/weights.py`` makes them, in one draw on the
device: a dense weight normal with variance 1 / fan-in, a bias 0.02 n,
BatchNorm's as there, LayerNorm's scale 1 + 0.05 n and shift 0.05 n.
Two departures, stated under the configuration's ``assumed``:

* the q and k rows of each ``c_qkv`` are multiplied by ``QK_GAIN``, so
  that the attention logits spread and a softmax row leans on part of the
  4,098 tokens (1 / sum p^2 of the median row, blocks 1-22: ~620-1,080
  on a traffic cloud), where at a gain of 1 a random model's rows are all
  but uniform (~2,100-3,400) and attention is a mean that any windowing
  of it misses little of; at 2.5 and above (~50-560) the sampler below
  cannot be held to a check;
* ``output_proj``'s weight is drawn at ``OUTPUT_GAIN`` times a dense
  layer's scale (Point-E initialises it to zero, which would predict zero
  noise). At a dense layer's scale the random network's noise is of unit
  size but follows nothing of the state, and 50 steps at guidance 7.5
  amplify rounding until a bfloat16 run parts from float32 by a sizeable
  share of the cloud (median point 0.13-0.56 of a radius of 1.8), even
  with the program's discrete choices pinned (0.015-0.027 at a tenth and
  a gain of 2.5), and neither the float8 control nor windowed attention
  can be told from a sound run; at 0.03 and a gain of 2 the pinned
  sampler stays in its linear range (0.0004) while every product does
  the same work.

Both gains were chosen for what the check can tell apart, not taken from a
trained model: no trained transformer's attention is at hand to hold the
~620-1,080 tokens against, and the small ``output_proj`` keeps the sampler
in a near-linear range that a served model is not in. A trained
checkpoint would replace both, and the check's pinning with them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import model_spec, seeds

Shapes = Dict[str, Tuple[int, ...]]
P = "noise_predictor"
QK_GAIN = 2.0
OUTPUT_GAIN = 0.03


def dense_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, in, out) of every dense layer of the transformer, in order."""
    spec = cfg["denoiser"]
    d, r = int(spec["width"]), int(spec["mlp_ratio"])
    layers = [(f"{P}.input_proj", 3, d),
              (f"{P}.style_embed", int(cfg["feature_dim"]), d),
              (f"{P}.time_embed.c_fc", d, 4 * d),
              (f"{P}.time_embed.c_proj", 4 * d, d)]
    for i in range(int(spec["layers"])):
        b = f"{P}.backbone.resblocks.{i}"
        layers += [(f"{b}.attn.c_qkv", d, 3 * d), (f"{b}.attn.c_proj", d, d),
                   (f"{b}.mlp.c_fc", d, r * d), (f"{b}.mlp.c_proj", r * d, d)]
    return layers + [(f"{P}.output_proj", d, 3)]


def layernorm_layers(cfg: dict) -> List[Tuple[str, int]]:
    d = int(cfg["denoiser"]["width"])
    names = [f"{P}.ln_pre"]
    for i in range(int(cfg["denoiser"]["layers"])):
        b = f"{P}.backbone.resblocks.{i}"
        names += [f"{b}.ln_1", f"{b}.ln_2"]
    return [(n, d) for n in names + [f"{P}.ln_post"]]


def shapes(cfg: dict) -> Shapes:
    """Every parameter and BatchNorm statistic: name -> shape."""
    out: Shapes = {}
    for name, c_in, c_out in (model_spec.encoder_layers(cfg)
                              + dense_layers(cfg)):
        out[f"{name}.weight"] = (c_out, c_in)
        out[f"{name}.bias"] = (c_out,)
    for name, c in model_spec.batchnorm_layers(cfg):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)
    for name, c in layernorm_layers(cfg):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)
    return out


def parameter_count(cfg: dict) -> int:
    """Trainable parameters: every tensor but the running statistics."""
    return sum(math.prod(s) for n, s in shapes(cfg).items()
               if not n.endswith(("running_mean", "running_var")))


def qk_rows(cfg: dict) -> torch.Tensor:
    """A [3d] mask of ``c_qkv``'s output rows that are q or k: head-major,
    each head's 3c rows [q | k | v]."""
    spec = cfg["denoiser"]
    d, H = int(spec["width"]), int(spec["heads"])
    c = d // H
    return (torch.arange(3 * d) % (3 * c)) < 2 * c


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``."""
    shp = shapes(cfg)
    sizes = [math.prod(s) for s in shp.values()]
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    qk = qk_rows(cfg).to(device)
    ln = {n for n, _ in layernorm_layers(cfg)}
    out = {}
    for (name, shape), n in zip(shp.items(), sizes):
        n_ = flat[:n].view(shape)
        flat = flat[n:]
        layer, leaf = name.rsplit(".", 1)
        if ".bns." in name:
            base = {"weight": 1.0, "running_var": 1.0}.get(leaf, 0.0)
            n_ = n_.abs() if leaf == "running_var" else n_
            out[name] = base + 0.05 * n_
        elif layer in ln:
            out[name] = (1.0 if leaf == "weight" else 0.0) + 0.05 * n_
        elif leaf == "weight":
            w = n_ / math.sqrt(shape[1])
            if layer.endswith(".c_qkv"):
                w = w * torch.where(qk, QK_GAIN, 1.0)[:, None]
            elif layer == f"{P}.output_proj":
                w = w * OUTPUT_GAIN
            out[name] = w
        else:
            out[name] = 0.02 * n_
    return out
