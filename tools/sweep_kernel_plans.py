"""Time every launch the kNN and FPS kernels take, at the shapes their plans
are chosen for, on one CUDA card.

``knn_topk``: every cluster size S at the kd-grid's patch sizes (500 to
32,768 rows), the brute path's 90,000 rows and the Chamfer gradient's 30,000
rows, each x 30,000 refs, k = 3 and (30,000 rows) k = 1. ``fps``: every
(S, threads, PER) that holds the cloud, at 30,000 -> 512, 8,192 -> 512,
512 -> 128 and 65,536 -> 512, in us per iteration. Every launch's result is
held identical to the plan's. The clouds are ``chip_smoke.py``'s.

Run from the root of a checkout on a machine with the CUDA toolkit:
``python3 tools/sweep_kernel_plans.py``. It prints one line per shape and
the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line, cuda_ms, make_cloud  # noqa: E402
from pointcloud_style_transfer_torch.data import \
    normalize_point_cloud  # noqa: E402
from pointcloud_style_transfer_torch.ops import index_points  # noqa: E402
from pointcloud_style_transfer_torch.ops.kernels import (  # noqa: E402
    build_all, fps_cuda, knn_topk_cuda)
from pointcloud_style_transfer_torch.ops.kernels.fps import (  # noqa: E402
    CLUSTER_SIZES as FPS_CLUSTER_SIZES, PERS, fps_plan)
from pointcloud_style_transfer_torch.ops.kernels.knn import (  # noqa: E402
    CLUSTER_SIZES, knn_topk_plan)

ROWS = (500, 1825, 2500, 4096, 16384, 32768, 90000, 30000)


def sweep_knn(query: torch.Tensor, ref: torch.Tensor,
              rng: np.random.Generator) -> None:
    m = ref.shape[1]
    for rows in ROWS:
        q = query[:, torch.from_numpy(np.sort(rng.choice(
            query.shape[1], rows, replace=False))).to(ref.device)].contiguous()
        for k in ((3, 1) if rows == 30000 else (3,)):
            plan = knn_topk_plan(1, rows, m)
            d, i = knn_topk_cuda(q, ref, k)
            times = {}
            for S in CLUSTER_SIZES:
                d2, i2 = knn_topk_cuda(q, ref, k, plan=S)
                if not (torch.equal(i2, i) and torch.equal(d2, d)):
                    raise SystemExit(f"knn_topk {rows}x{m} S={S} differs")
                times[S] = cuda_ms(lambda: knn_topk_cuda(q, ref, k, plan=S),
                                   reps=20)
            best = min(times, key=times.get)
            print(f"[knn sweep] {rows}x{m} k={k}: plan S={plan}, fastest "
                  f"S={best}; ms by S: " + " ".join(
                      f"{S} {t:.4f}" for S, t in times.items()))


def sweep_fps(ref: torch.Tensor, big: torch.Tensor) -> None:
    start = torch.zeros(1, dtype=torch.int32, device=ref.device)
    small = index_points(ref, fps_cuda(ref, 512, start)).contiguous()
    for xyz, npoint in ((ref, 512), (ref[:, :8192].contiguous(), 512),
                        (small, 128), (big, 512)):
        n = xyz.shape[1]
        want = fps_cuda(xyz, npoint, start)
        times = {}
        for S in FPS_CLUSTER_SIZES:
            for threads in (32, 64, 128, 256, 512, 1024):
                per = next((p for p in PERS if threads * p >= -(-n // S)),
                           None)
                if per is None or (threads > 32 and threads // 2 >= -(-n // S)):
                    continue  # cannot hold the slice, or half the threads do
                plan = (S, threads, per)
                if not torch.equal(fps_cuda(xyz, npoint, start, plan=plan),
                                   want):
                    raise SystemExit(f"fps {n}->{npoint} plan {plan} differs")
                times[plan] = 1e3 * cuda_ms(lambda: fps_cuda(
                    xyz, npoint, start, plan=plan), reps=10) / npoint
        best = min(times, key=times.get)
        print(f"[fps sweep] {n}->{npoint}: plan {fps_plan(n)} "
              f"{times[fps_plan(n)]:.3f}, fastest {best} {times[best]:.3f} us "
              "per iteration; all (S/threads/PER): " + " ".join(
                  f"{S}/{t}/{p} {u:.3f}" for (S, t, p), u in times.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    build_all(["knn_topk", "fps"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 30000))[0])[None].to(dev)
    query = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 90000))[0])[None].to(dev)
    big = torch.from_numpy(normalize_point_cloud(make_cloud(
        rng, 65536))[0])[None].to(dev)
    sweep_knn(query, ref, rng)
    sweep_fps(ref, big)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
