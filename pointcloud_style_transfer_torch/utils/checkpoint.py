"""Port checkpoints.

Two forms, both read by ``load_for_inference``:

* **a training checkpoint directory** (``CheckpointManager``), the JAX
  package's directory contract with a ``.pt`` payload:
  ``{checkpoint_dir}/{experiment_name}/ckpt_epoch_{epoch:04d}/`` holding
  ``state.pt`` (``params``, ``batch_stats``, ``opt_state``, ``ema_params``)
  and ``meta.json`` (``epoch``, ``config``, ``best_val_loss``,
  ``denoiser``), plus a ``best_model/`` copy updated on improvement;
  ``load_latest`` finds the newest epoch and returns the next one to run;
* **a single ``.pt`` file** (``save_checkpoint``): ``config``, ``params``,
  ``batch_stats``, optional ``ema_params`` and ``denoiser``.

``denoiser`` is the noise predictor's spec beside the config
(``models.transformer.TransformerSpec.to_dict()``, or None for the residual
MLP; a checkpoint without the entry is the MLP's), so that
``load_for_inference`` rebuilds the network it holds.

Tensors are stored on the CPU by state-dict name and read with
``weights_only=True``. ``convert.py`` turns JAX variables and train states
into the same names. A checkpoint directory of the JAX package (orbax
arrays beside the same ``meta.json``) is converted once, where JAX and
orbax are installed, by ``tools/orbax_to_torch.py`` (one epoch directory or
a whole experiment); ``restore`` given such a directory raises an error
that names it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import Config
from ..device import resolve_device

StateDict = Dict[str, torch.Tensor]

_EPOCH_RE = re.compile(r"ckpt_epoch_(\d+)$")
STATE_FILE, META_FILE = "state.pt", "meta.json"


def split_state_dict(net: torch.nn.Module) -> Tuple[StateDict, StateDict]:
    """(params, batch_stats) of a module: its parameters and its buffers."""
    params = {k: v.detach().cpu() for k, v in net.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in net.named_buffers()}
    return params, stats


def to_cpu(tree: Any) -> Any:
    """A copy of nested dicts/lists of tensors with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _spec_dict(denoiser) -> Optional[dict]:
    return None if denoiser is None else denoiser.to_dict()


def save_checkpoint(path: str, config: Config, params: StateDict,
                    batch_stats: StateDict,
                    ema_params: Optional[StateDict] = None,
                    denoiser=None) -> str:
    """``denoiser``: the noise predictor's ``TransformerSpec``, or None for
    the residual MLP."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"config": config.to_dict(), "params": params,
                "batch_stats": batch_stats, "ema_params": ema_params,
                "denoiser": _spec_dict(denoiser)}, path)
    return path


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """The training checkpoint directories of one experiment."""

    def __init__(self, checkpoint_dir: str, experiment_name: str,
                 max_to_keep: Optional[int] = None):
        self.base_dir = os.path.abspath(
            os.path.join(checkpoint_dir, experiment_name))
        os.makedirs(self.base_dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.base_dir, f"ckpt_epoch_{epoch:04d}")

    @property
    def best_dir(self) -> str:
        return os.path.join(self.base_dir, "best_model")

    def list_epochs(self):
        out = []
        for name in os.listdir(self.base_dir):
            m = _EPOCH_RE.match(name)
            if m and os.path.isdir(os.path.join(self.base_dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, state: Dict[str, Any], epoch: int, config: Config,
             is_best: bool = False, best_val_loss: float = float("inf"),
             denoiser=None) -> str:
        """``state``: nested dicts of tensors (params, batch_stats,
        opt_state, ema_params); written to the CPU. ``denoiser`` as for
        ``save_checkpoint``, into ``meta.json``."""
        path = self.epoch_dir(epoch)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(to_cpu(state), os.path.join(path, STATE_FILE))
        meta = {"epoch": epoch, "config": config.to_dict(),
                "best_val_loss": best_val_loss,
                "denoiser": _spec_dict(denoiser)}
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(meta, f, indent=2)
        if is_best:
            if os.path.exists(self.best_dir):
                shutil.rmtree(self.best_dir)
            shutil.copytree(path, self.best_dir)
        if self.max_to_keep:
            for old in self.list_epochs()[:-self.max_to_keep]:
                shutil.rmtree(self.epoch_dir(old), ignore_errors=True)
        return path

    @staticmethod
    def restore(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(state, meta) of one checkpoint directory, tensors on the CPU."""
        check_port_checkpoint_dir(path)
        state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        return state, meta

    def load_latest(self) -> Tuple[Optional[Dict[str, Any]], Dict[str, Any],
                                   int]:
        """(state | None, meta, next_epoch) of the newest checkpoint;
        next_epoch is 0 when there is none."""
        epochs = self.list_epochs()
        if not epochs:
            return None, {}, 0
        state, meta = self.restore(self.epoch_dir(epochs[-1]))
        return state, meta, epochs[-1] + 1


def check_port_checkpoint_dir(path: str) -> None:
    """Raise unless ``path`` holds a port payload: a JAX package checkpoint
    (``meta.json`` and orbax arrays, no ``state.pt``) must be converted
    first."""
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return
    if os.path.exists(os.path.join(path, META_FILE)):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: it looks like a checkpoint of the "
            "JAX package (orbax). Convert it where JAX and orbax are "
            "installed: python tools/orbax_to_torch.py "
            f"--checkpoint {path} --output <port checkpoint dir>")
    raise FileNotFoundError(f"no checkpoint ({STATE_FILE}, {META_FILE}) in "
                            f"{path}")


def load_checkpoint_config(path: str) -> Config:
    """The ``Config`` embedded in a training checkpoint directory (its
    ``meta.json``) or in a single ``.pt`` file."""
    if os.path.isdir(path):
        with open(os.path.join(path, META_FILE)) as f:
            return Config.from_dict(json.load(f)["config"])
    return Config.from_dict(load_checkpoint(path)["config"])


def load_for_inference(path: str, device: str | torch.device | None = None):
    """Rebuild (config, model) on ``device`` (default ``cuda``) from a
    training checkpoint directory or a single ``.pt`` file, with the noise
    predictor its ``denoiser`` entry names. EMA weights are preferred,
    falling back to the raw params."""
    from ..models import PointCloudDiffusionModel
    from ..models.transformer import denoiser_spec

    device = resolve_device(device)
    if os.path.isdir(path):
        ckpt, meta = CheckpointManager.restore(path)
    else:
        ckpt = meta = load_checkpoint(path)
    config = Config.from_dict(meta["config"])
    model = PointCloudDiffusionModel(config, device, denoiser=denoiser_spec(
        meta.get("denoiser")))
    weights = ckpt.get("ema_params") or ckpt["params"]
    model.net.load_state_dict({**weights, **ckpt["batch_stats"]})
    return config, model
