"""Exponential moving average of the parameters (counterpart of
``pointcloud_style_transfer_tpu/training/ema.py``). Parameters are a dict of
tensors by state-dict name; evaluating "under the EMA weights" is
``torch.func.functional_call`` with this dict, so there is no swap/restore."""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def ema_init(params: Params) -> Params:
    """Shadow = a DISTINCT copy of the parameters (no aliasing)."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Params, params: Params, decay: float = 0.999,
               emit: Optional[torch.Tensor] = None) -> None:
    """In place: shadow = decay * shadow + (1 - decay) * param; with
    ``emit`` (a 0-d bool tensor) only where it holds, selected on the device
    as the JAX step's ``jnp.where(did_step, ...)``, so that nothing is read
    back to the host."""
    for k, e in ema_params.items():
        new = decay * e + (1.0 - decay) * params[k].detach()
        e.copy_(new if emit is None else torch.where(emit, new, e))


class _Call(torch.nn.Module):
    """Holds ``net`` as a submodule so that ``functional_call`` can swap its
    parameters around an arbitrary callable."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def call_with_params(net: torch.nn.Module, params: Params, fn, *args,
                     **kwargs):
    """``fn(*args, **kwargs)`` with ``net``'s parameters replaced by
    ``params`` (by state-dict name) for the duration of the call; buffers
    (BatchNorm running stats) stay ``net``'s own."""
    swapped = {f"net.{k}": v for k, v in params.items()}
    return torch.func.functional_call(_Call(net), swapped, (fn, *args),
                                      kwargs)
