"""Seeded weights for the network, made on the device in one draw.

No trained checkpoint of the model is public, so a run serves and trains
random weights: every product then does the work a trained network's
would. A dense layer's weight is normal with variance 1 / fan-in (the
initialisation's scale, so activations stay of order one through the
residual stack), its bias normal at 0.02; BatchNorm's scale is
1 + 0.05 n, its shift and running mean 0.05 n, its running variance
1 + 0.05 |n|."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import model_spec, seeds


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``."""
    shapes = model_spec.shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), n in zip(shapes.items(), sizes):
        n_ = flat[:n].view(shape)
        flat = flat[n:]
        leaf = name.rsplit(".", 1)[1]
        if ".bns." in name:
            base = {"weight": 1.0, "running_var": 1.0}.get(leaf, 0.0)
            n_ = n_.abs() if leaf == "running_var" else n_
            out[name] = base + 0.05 * n_
        elif leaf == "weight":
            out[name] = n_ / math.sqrt(shape[1])
        else:
            out[name] = 0.02 * n_
    return out
