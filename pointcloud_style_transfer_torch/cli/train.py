"""Train CLI (counterpart of ``pointcloud_style_transfer_tpu/cli/train.py``):
``Config()`` with the flags given, the processed dataset's train/val
batchers, and ``DiffusionTrainer`` on ``--device`` (default ``cuda``).
``--denoiser`` picks the noise predictor: ``mlp`` (the residual MLP, the
default) or one of Point-E's transformer presets (``point-e-base40M``,
``point-e-base300M``, ``point-e-base1B``); its checkpoints hold the choice.

    python -m pointcloud_style_transfer_torch.cli.train \\
        --data_dir datasets/processed --num_epochs 2 [--device cpu] \\
        [--denoiser point-e-base40M]
"""

from __future__ import annotations

import argparse

from ..config import Config
from ..data import create_dataloaders
from ..device import resolve_device
from ..models.transformer import PRESETS
from ..training import DiffusionTrainer
from ..utils.cache import enable_compilation_cache
from ._common import add_config_overrides, apply_overrides


DENOISERS = ("mlp", *(f"point-e-{name}" for name in PRESETS))


def denoiser_of(name: str):
    """The ``--denoiser`` choice's spec: None for ``mlp``, else the Point-E
    preset it names."""
    return None if name == "mlp" else PRESETS[name[len("point-e-"):]]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Train the point-cloud style-transfer diffusion model")
    add_config_overrides(parser)
    parser.add_argument("--no_resume", action="store_true",
                        help="start fresh even if checkpoints exist")
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--use_hierarchical", type=int, default=None,
                        choices=(0, 1))
    parser.add_argument("--val_interval", type=int, default=None)
    parser.add_argument("--denoiser", default="mlp", choices=DENOISERS,
                        help="the noise predictor: the residual MLP or a "
                        "Point-E transformer preset")
    args = parser.parse_args(argv)
    enable_compilation_cache()

    config = apply_overrides(Config(), args)
    if args.learning_rate is not None:
        config = config.replace(learning_rate=args.learning_rate)
    if args.use_hierarchical is not None:
        config = config.replace(use_hierarchical=bool(args.use_hierarchical))
    if args.val_interval is not None:
        config = config.replace(val_interval=args.val_interval)

    device = resolve_device(args.device)
    train_loader, val_loader = create_dataloaders(config)
    trainer = DiffusionTrainer(config, resume=not args.no_resume,
                               device=device,
                               denoiser=denoiser_of(args.denoiser))
    trainer.train(train_loader, val_loader)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
