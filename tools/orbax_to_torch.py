#!/usr/bin/env python3
"""Convert checkpoints of the JAX package (orbax) into the PyTorch port's.

A JAX training checkpoint directory (``ckpt_epoch_NNNN/`` or
``best_model/``) holds the trainer's state as orbax arrays beside a
``meta.json`` (epoch, config, best validation loss). The port reads
``state.pt`` beside the same ``meta.json`` (its
``utils/checkpoint.py``). This script restores the orbax state against a
template built from the checkpoint's own config, as the JAX trainer builds
its state (model init, optax optimizer, EMA), so that optax's states come
back as the named tuples ``convert.train_state_to_torch`` reads; then it
writes the port's directory: ``state.pt`` and ``meta.json`` unchanged.

Run it where JAX and orbax are installed (the port itself needs neither):

    python tools/orbax_to_torch.py --checkpoint checkpoints/exp/best_model \
        --output port_ckpts/exp/best_model
    python tools/orbax_to_torch.py --checkpoint checkpoints/exp \
        --output port_ckpts/exp     # every ckpt_epoch_* and best_model

The output must not exist (``--overwrite`` replaces it) and may not lie
inside the checkpoint nor hold it. Everything is written into a temporary
sibling of the output first and renamed into place when it is complete.

The output serves ``python -m pointcloud_style_transfer_torch.cli.inference
--checkpoint port_ckpts/exp/best_model ...``, and an experiment directory
resumes training with the port's ``DiffusionTrainer``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile

import jax
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pointcloud_style_transfer_torch.convert import (  # noqa: E402
    train_state_to_torch)
from pointcloud_style_transfer_torch.utils.checkpoint import (  # noqa: E402
    META_FILE, STATE_FILE, to_cpu)
from pointcloud_style_transfer_tpu.config import Config  # noqa: E402

_CKPT_RE = re.compile(r"^(ckpt_epoch_\d+|best_model)$")


def state_template(config: Config):
    """The JAX trainer's state {params, batch_stats, opt_state, ema_params}
    for ``config`` as shapes and dtypes only (``jax.eval_shape``: nothing
    is computed), with optax's state types."""
    from pointcloud_style_transfer_tpu.models import PointCloudDiffusionModel
    from pointcloud_style_transfer_tpu.training.ema import ema_init
    from pointcloud_style_transfer_tpu.training.trainer import make_optimizer

    model = PointCloudDiffusionModel(config)
    tx = make_optimizer(config)

    def build():
        variables = model.init(jax.random.PRNGKey(config.seed),
                               example_points=min(config.global_points,
                                                  4096))
        params = variables["params"]
        return {"params": params,
                "batch_stats": variables.get("batch_stats", {}),
                "opt_state": tx.init(params),
                "ema_params": ema_init(params)}
    return jax.eval_shape(build)


def convert_dir(src: str, dst: str) -> None:
    """One JAX checkpoint directory -> the port's at ``dst`` (new)."""
    with open(os.path.join(src, META_FILE)) as f:
        meta = json.load(f)
    template = state_template(Config.from_dict(meta["config"]))
    state = ocp.StandardCheckpointer().restore(os.path.abspath(src),
                                               template)
    state = jax.tree_util.tree_map(jax.device_get, state)
    os.makedirs(dst)
    torch.save(to_cpu(train_state_to_torch(state)),
               os.path.join(dst, STATE_FILE))
    shutil.copyfile(os.path.join(src, META_FILE), os.path.join(dst, META_FILE))


def _check_paths(src: str, dst: str, overwrite: bool) -> None:
    s, d = os.path.realpath(src), os.path.realpath(dst)
    if os.path.commonpath([s, d]) in (s, d):
        raise ValueError(f"the output {dst} is, holds or lies inside the "
                         f"checkpoint {src}: choose another directory")
    if os.path.lexists(dst) and not overwrite:
        raise FileExistsError(f"{dst} exists: pass --overwrite to replace "
                              "it")


def convert(src: str, dst: str, overwrite: bool = False) -> list[str]:
    """Convert ``src``, one checkpoint directory (it holds ``meta.json``) or
    an experiment directory (every ``ckpt_epoch_*`` and ``best_model`` in
    it), into ``dst``; returns the directories written."""
    _check_paths(src, dst, overwrite)
    if os.path.exists(os.path.join(src, META_FILE)):
        names = [None]
    else:
        names = sorted(n for n in os.listdir(src) if _CKPT_RE.match(n)
                       and os.path.exists(os.path.join(src, n, META_FILE)))
        if not names:
            raise FileNotFoundError(
                f"no JAX checkpoint ({META_FILE}) in {src} or its "
                "ckpt_epoch_*/best_model directories")
    parent = os.path.dirname(os.path.abspath(dst))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=f".{os.path.basename(dst)}.")
    out = os.path.join(tmp, "out")
    try:
        for n in names:
            if n is None:
                convert_dir(src, out)
            else:
                convert_dir(os.path.join(src, n), os.path.join(out, n))
        if os.path.isdir(dst) and not os.path.islink(dst):
            shutil.rmtree(dst)
        elif os.path.lexists(dst):
            os.remove(dst)
        os.rename(out, dst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [dst if n is None else os.path.join(dst, n) for n in names]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True,
                        help="a JAX checkpoint directory (ckpt_epoch_NNNN, "
                             "best_model) or an experiment directory")
    parser.add_argument("--output", required=True,
                        help="where the port's directory (or directories) "
                             "go; it must not exist")
    parser.add_argument("--overwrite", action="store_true",
                        help="replace an existing output")
    args = parser.parse_args(argv)
    for path in convert(args.checkpoint, args.output, args.overwrite):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
