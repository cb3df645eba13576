"""Flax variables and JAX train states -> the port's state dicts.

The JAX package's ``model.init`` gives ``{"params", "batch_stats"}`` nested
by module name (``Dense_i``, ``BatchNorm_i``, ``SetAbstraction_i``, ...).
These functions take that tree as nested dicts of arrays (numpy, or anything
``np.asarray`` reads) and return the matching ``state_dict`` of the port's
modules:

* a Flax ``Dense.kernel`` [in, out] is a ``Linear.weight`` [out, in];
* a Flax BatchNorm's ``scale``/``bias`` and ``mean``/``var`` are the torch
  module's ``weight``/``bias`` and ``running_mean``/``running_var``; eps is
  1e-5 in both, and Flax momentum 0.9 is torch momentum 0.1 (set on the
  module, nothing to convert).

Flax numbers Dense layers in call order. NoisePredictor: 0-2 point encoder,
3 time projection, 4 style projection, 5-16 the six residual blocks (two
each), 17-19 output MLP. StyleEncoder: ``PointNet2Encoder_0`` with
``SetAbstraction_0..2``, then head ``Dense_0`` and ``Dense_1``.

A tree shaped like the params (EMA shadow, Adam moments, accumulated
gradients) maps through ``params_to_torch``; ``train_state_to_torch`` carries
a whole JAX train state across, so both packages can start from the same
state, mid-accumulation included.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(p: Mapping) -> StateDict:
    return {"weight": _t(p["kernel"]).T.contiguous(), "bias": _t(p["bias"])}


def _batchnorm(p: Mapping, s: Optional[Mapping]) -> StateDict:
    sd = {"weight": _t(p["scale"]), "bias": _t(p["bias"])}
    if s is not None:
        sd.update(running_mean=_t(s["mean"]), running_var=_t(s["var"]),
                  num_batches_tracked=torch.tensor(0, dtype=torch.int64))
    return sd


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def noise_predictor_state(params: Mapping, num_blocks: int = 6) -> StateDict:
    """State dict of ``NoisePredictor`` from its Flax params."""
    names = ([f"point_encoder.{i}" for i in range(3)]
             + ["time_proj", "style_proj"]
             + [f"blocks.{b}.{j}" for b in range(num_blocks) for j in range(2)]
             + [f"output_mlp.{i}" for i in range(3)])
    sd: StateDict = {}
    for i, name in enumerate(names):
        sd.update(_prefixed(name, _dense(params[f"Dense_{i}"])))
    return sd


def style_encoder_state(params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> StateDict:
    """State dict of ``StyleEncoder`` from its Flax params and batch stats
    (without ``batch_stats``: its parameters only)."""
    enc_p = params["PointNet2Encoder_0"]
    sd: StateDict = {}
    for i in range(3):
        sa_p = enc_p[f"SetAbstraction_{i}"]
        sa_s = (None if batch_stats is None else
                batch_stats["PointNet2Encoder_0"][f"SetAbstraction_{i}"])
        n_layers = sum(1 for k in sa_p if k.startswith("Dense_"))
        for j in range(n_layers):
            base = f"encoder.sa{i + 1}"
            sd.update(_prefixed(f"{base}.linears.{j}", _dense(sa_p[f"Dense_{j}"])))
            sd.update(_prefixed(f"{base}.bns.{j}", _batchnorm(
                sa_p[f"BatchNorm_{j}"],
                None if sa_s is None else sa_s[f"BatchNorm_{j}"])))
    sd.update(_prefixed("fc1", _dense(params["Dense_0"])))
    sd.update(_prefixed("fc2", _dense(params["Dense_1"])))
    return sd


def flax_to_torch(variables: Mapping) -> StateDict:
    """State dict of ``DiffusionNet`` from the JAX package's DiffusionNet
    variables ``{"params": ..., "batch_stats": ...}``."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd = _prefixed("style_encoder", style_encoder_state(
        params["style_encoder"], stats["style_encoder"]))
    sd.update(_prefixed("noise_predictor",
                        noise_predictor_state(params["noise_predictor"])))
    return sd


def params_to_torch(params: Mapping) -> StateDict:
    """``DiffusionNet``'s parameters (no buffers) from a tree shaped like the
    Flax params: the params themselves, the EMA shadow, an Adam moment or
    the accumulated gradients."""
    sd = _prefixed("style_encoder", style_encoder_state(
        params["style_encoder"]))
    sd.update(_prefixed("noise_predictor",
                        noise_predictor_state(params["noise_predictor"])))
    return sd


def train_state_to_torch(state: Mapping) -> Dict[str, Any]:
    """The JAX trainer's state ``{params, batch_stats, opt_state,
    ema_params}`` in the port's layout: ``DiffusionTrainer.state()``'s, with
    optax's ``MultiStepsState`` as ``opt_state`` (``mini_step``,
    ``gradient_step``, Adam's ``count``, ``mu``, ``nu`` and ``acc_grads``).
    """
    opt = state["opt_state"]
    adam = next(s for s in opt.inner_opt_state if hasattr(s, "mu"))
    return {
        "params": params_to_torch(state["params"]),
        "batch_stats": {k: v for k, v in flax_to_torch(
            {"params": state["params"],
             "batch_stats": state["batch_stats"]}).items()
            if "running" in k or "num_batches" in k},
        "ema_params": params_to_torch(state["ema_params"]),
        "opt_state": {"mini_step": int(opt.mini_step),
                      "gradient_step": int(opt.gradient_step),
                      "count": int(adam.count),
                      "mu": params_to_torch(adam.mu),
                      "nu": params_to_torch(adam.nu),
                      "acc_grads": params_to_torch(opt.acc_grads)},
    }
