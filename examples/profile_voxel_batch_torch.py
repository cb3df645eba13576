"""Voxel-downsample batch scaling on the PyTorch port: the counterpart of
``examples/profile_voxel_batch.py``. ``voxel_downsample_partition`` at the
sampler's geometry (120,000 -> 30,000 points, each cloud's priority order
and its coordinates gathered) for B clouds: is it linear in B? The port
orders each cloud of a batch on its own (``ops/voxel.py``), where the JAX
package sorts the batch flat on a composite key.

``--chain`` calls (10), each on its own priorities, run in one body; on the
card the body is one CUDA graph replayed ``--reps`` times (5) between CUDA
events. Prints ms a call, ms a cloud and the ratio to B = 1.

Usage: python examples/profile_voxel_batch_torch.py [B ...] [--points
           120000] [--global_points 30000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_common_torch as common  # noqa: E402
from pointcloud_style_transfer_torch.device import resolve_device  # noqa: E402
from pointcloud_style_transfer_torch.models import capture  # noqa: E402
from pointcloud_style_transfer_torch.ops import \
    voxel_downsample_partition  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("batches", nargs="*", type=int, default=[1, 2, 4])
    parser.add_argument("--points", type=int, default=120000)
    parser.add_argument("--global_points", type=int, default=30000)
    parser.add_argument("--chain", type=int, default=10)
    parser.add_argument("--reps", type=int, default=5)
    common.script_args(parser, config=False)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    N, M, chain = args.points, args.global_points, args.chain
    card = common.device_name(dev)
    print(f"device={card} N={N} M={M} chain={chain} reps={args.reps}",
          flush=True)
    owner = common.Owner()

    def body(ins):
        out = ins["x"].new_zeros(())
        for i in range(chain):
            sel, idx, comp, cxyz = voxel_downsample_partition(
                ins["x"], M, priority=ins["priorities"][i])
            out = out + sel[:, 0].sum() + cxyz[:, 0].sum()
        return out
    readings, base = {}, None
    for B in args.batches:
        gen = torch.Generator(device=dev).manual_seed(common.SEED)
        ins = {"x": torch.randn((B, N, 3), generator=gen, device=dev),
               "priorities": torch.rand((chain, B, N), generator=gen,
                                        device=dev)}
        capture.release()
        run = functools.partial(common.run_body, ("voxel_batch", B, N, M,
                                                  chain), body, ins, owner,
                                dev)
        res = common.measure(run, args.reps, dev)
        if not torch.isfinite(res["first"]):
            raise RuntimeError(f"B={B}: output not finite")
        per = [ms / chain for ms in res["ms"]]
        med = statistics.median(per)
        base = base or med
        readings[B] = {"ms": med, "ms_per_cloud": med / B,
                       "spread": common.spread(per), "vs_b1": med / base}
        print(f"B={B}: {med:.4f} ms/call ({med / B:.4f} ms/cloud, "
              f"{med / base:.2f}x vs B={args.batches[0]}; spread "
              f"{100 * common.spread(per):.1f}%)", flush=True)
    capture.release()
    return {"device": card, "N": N, "M": M, "by_batch": readings}


if __name__ == "__main__":
    main()
