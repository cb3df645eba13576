"""Port checkpoints: one ``.pt`` file holding the config and the weights.

Payload (a dict; tensors on the CPU, readable with ``weights_only=True``):

* ``config``: ``Config.to_dict()`` — inference rebuilds the model from it;
* ``params``: the DiffusionNet's parameters, by state-dict name;
* ``batch_stats``: its BatchNorm buffers (running mean / var / count);
* ``ema_params``: optional EMA shadow of ``params``, preferred for inference.

``flax_to_torch`` (``convert.py``) turns JAX variables into the same names.
Reading the JAX package's orbax checkpoints is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..config import Config
from ..device import resolve_device

StateDict = Dict[str, torch.Tensor]


def split_state_dict(net: torch.nn.Module) -> Tuple[StateDict, StateDict]:
    """(params, batch_stats) of a module: its parameters and its buffers."""
    params = {k: v.detach().cpu() for k, v in net.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in net.named_buffers()}
    return params, stats


def save_checkpoint(path: str, config: Config, params: StateDict,
                    batch_stats: StateDict,
                    ema_params: Optional[StateDict] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"config": config.to_dict(), "params": params,
                "batch_stats": batch_stats, "ema_params": ema_params}, path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_for_inference(path: str, device: str | torch.device | None = None):
    """Rebuild (config, model) from a port checkpoint on ``device`` (default
    ``cuda``). EMA weights are preferred, falling back to the raw params."""
    from ..models import PointCloudDiffusionModel

    device = resolve_device(device)
    ckpt = load_checkpoint(path)
    config = Config.from_dict(ckpt["config"])
    model = PointCloudDiffusionModel(config, device)
    weights = ckpt.get("ema_params") or ckpt["params"]
    model.net.load_state_dict({**weights, **ckpt["batch_stats"]})
    return config, model
