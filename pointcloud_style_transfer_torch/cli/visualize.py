"""Visualize CLI: a 3-panel plot of original / generated / reference clouds
and an optional PLY export (counterpart of
``pointcloud_style_transfer_tpu/cli/visualize.py``, same flags). It runs no
tensor code, so it takes no ``--device``.

    python -m pointcloud_style_transfer_torch.cli.visualize \\
        --original sim.npy --generated out.npy --reference real.npy \\
        --output plot.png [--export_ply out.ply] [--interactive]
"""

from __future__ import annotations

import argparse

from ..utils.visualization import (plot_style_transfer_result, save_as_ply,
                                   visualize_interactive)
from ._common import load_point_cloud


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Visualize style transfer "
                                                 "results")
    parser.add_argument("--original", type=str, required=True)
    parser.add_argument("--generated", type=str, required=True)
    parser.add_argument("--reference", type=str, required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="output .png (shows interactively if omitted)")
    parser.add_argument("--title", type=str, default="Style Transfer Result")
    parser.add_argument("--sample_size", type=int, default=8000)
    parser.add_argument("--export_ply", type=str, default=None,
                        help="also export the generated cloud as .ply")
    parser.add_argument("--interactive", action="store_true",
                        help="open3d interactive viewer (requires open3d)")
    args = parser.parse_args(argv)

    orig = load_point_cloud(args.original)
    gen = load_point_cloud(args.generated)
    ref = load_point_cloud(args.reference)

    if args.interactive:
        visualize_interactive(
            [orig, gen, ref], ["original", "generated", "reference"],
            colors=[[0.2, 0.4, 0.9], [0.9, 0.4, 0.2], [0.3, 0.8, 0.3]])

    ok = plot_style_transfer_result(orig, gen, ref, title=args.title,
                                    save_path=args.output,
                                    sample_size=args.sample_size)
    if not ok:
        print("matplotlib not available — no plot produced")
    if args.export_ply:
        save_as_ply(gen, args.export_ply)
        print(f"PLY saved to {args.export_ply}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
