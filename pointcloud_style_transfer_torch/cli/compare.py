"""Compare CLI: precision/recall/F1 at a distance threshold and the Chamfer
distance between two point clouds (counterpart of
``pointcloud_style_transfer_tpu/cli/compare.py``, same JSON keys). On
``--device cuda`` (the default) each of the four row minima is one launch of
the row-min kernel.

    python -m pointcloud_style_transfer_torch.cli.compare gen.npy ref.npy \\
        [--threshold 0.2] [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..evaluation import chamfer_distance, precision_recall_f1
from ._common import load_point_cloud


@torch.no_grad()
def calculate_similarity(generated, reference, threshold: float = 0.2,
                         device: str | torch.device | None = None) -> dict:
    device = resolve_device(device)
    g = torch.from_numpy(np.asarray(generated, np.float32))[None].to(device)
    r = torch.from_numpy(np.asarray(reference, np.float32))[None].to(device)
    p, rec, f1 = precision_recall_f1(g, r, threshold=threshold)
    cd = chamfer_distance(g, r)
    return {"precision": float(p), "recall": float(rec), "f1": float(f1),
            "chamfer_distance": float(cd[0]), "threshold": threshold,
            "generated_points": int(g.shape[1]),
            "reference_points": int(r.shape[1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Similarity metrics between two point clouds")
    parser.add_argument("generated", type=str)
    parser.add_argument("reference", type=str)
    parser.add_argument("--threshold", type=float, default=0.2)
    parser.add_argument("--json", action="store_true",
                        help="print machine-readable JSON")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    result = calculate_similarity(load_point_cloud(args.generated),
                                  load_point_cloud(args.reference),
                                  args.threshold, args.device)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(f"Precision@{args.threshold}: {result['precision']:.4f}")
        print(f"Recall@{args.threshold}:    {result['recall']:.4f}")
        print(f"F1@{args.threshold}:        {result['f1']:.4f}")
        print(f"Chamfer distance:  {result['chamfer_distance']:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
