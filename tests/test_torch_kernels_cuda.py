"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a GPU with the CUDA toolkit (the kernels are built from ``csrc/`` on
first use); skipped without one. The file needs no JAX, so on a GPU machine
without it run ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda
--noconftest -q``. Indices must be identical, kNN distances within 1e-6
relative (same float32 arithmetic, no FMA).
"""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import (
    LAUNCH_COUNTS, ball_query_cuda, ball_query_plain, fps_cuda, fps_plain,
    knn_topk, knn_topk_cuda, knn_topk_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def points(rng, b, n, dup_frac=0.1):
    x = rng.standard_normal((b, n, 3)).astype(np.float32)
    k = int(n * dup_frac)
    x[:, rng.choice(n, k, replace=False)] = x[:, rng.choice(n, k)]
    return x


@pytest.mark.parametrize("b,n,m,k", [(1, 5000, 3000, 3), (2, 1000, 2500, 1),
                                     (1, 700, 5, 8), (1, 300, 2, 3)])
def test_knn_kernel_matches_plain(rng, cuda, b, n, m, k):
    r = points(rng, b, m)
    q = points(rng, b, n)
    q[:, : n // 5] = r[:, rng.choice(m, n // 5)]  # zero-distance ties
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    before = LAUNCH_COUNTS["knn_topk"]
    d, i = knn_topk(qt, rt, k)
    assert LAUNCH_COUNTS["knn_topk"] == before + 1
    d_p, i_p = knn_topk_plain(qt, rt, k)
    assert torch.equal(i, i_p)
    rel = (d - d_p).abs() / d_p.abs().clamp(min=1e-30)
    assert rel.max().item() <= 1e-6


@pytest.mark.parametrize("b,n,npoint", [(1, 30000, 512), (2, 512, 128),
                                        (3, 1500, 200), (1, 40000, 64)])
def test_fps_kernel_matches_plain(rng, cuda, b, n, npoint):
    x = np.round(points(rng, b, n) * 8) / 8  # lattice: tied maxima
    xt = torch.from_numpy(x.astype(np.float32)).to(cuda)
    start = torch.from_numpy(rng.integers(0, n, b).astype(np.int32)).to(cuda)
    assert torch.equal(fps_cuda(xt, npoint, start),
                       fps_plain(xt, npoint, start))


@pytest.mark.parametrize("s,n,radius,ns", [(512, 30000, 0.2, 32),
                                           (128, 512, 0.4, 64),
                                           (300, 2000, 0.05, 16),
                                           (50, 20, 1.0, 40)])
def test_ball_query_kernel_matches_plain(rng, cuda, s, n, radius, ns):
    x = points(rng, 2, n) * 0.5
    c = np.concatenate([x[:, : s // 2],
                        points(rng, 2, s - s // 2, 0.0) * 2], axis=1)
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    assert torch.equal(ball_query_cuda(radius, ns, xt, ct),
                       ball_query_plain(radius, ns, xt, ct))


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((1, 10, 3), device=cuda)
    with pytest.raises(ValueError):
        knn_topk_cuda(x.double(), x, 3)
    with pytest.raises(ValueError):
        knn_topk_cuda(x, x, 9)
    with pytest.raises(ValueError):
        knn_topk_cuda(x.cpu(), x, 3)
    with pytest.raises(ValueError):
        fps_cuda(x, 4, torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ball_query_cuda(0.1, 4, x[:, ::2], x)
