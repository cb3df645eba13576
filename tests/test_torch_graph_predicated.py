"""``knn_topk`` with its count on the device: the plain twin of the
predicated kernel (``row_ids`` gather the query rows, ``count`` bounds the
rows computed per cloud) against the unpredicated plain version on the
gathered rows. Below each cloud's count the rows must be identical (indices
and distance bits); at or past it every row holds the start list (1e30, 0),
as the kernel writes it. Counts of 0, the whole buffer, and counts that end
inside a 128-row query block (the kernel's, and a cluster's, unit of work),
at k = 3 (register lists) and 17 (the global-list variant), one cloud and
three. The f32-packed kernel's twin takes the count the same way."""

import numpy as np
import pytest
import torch

from pointcloud_style_transfer_torch.ops.kernels import knn as K
from pointcloud_style_transfer_torch.ops.kernels import knn_packed as P

N_SRC, N_BUF, M = 700, 520, 300


def clouds(B, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N_SRC, 3)).astype(np.float32)
    r = rng.standard_normal((B, M, 3)).astype(np.float32)
    r[:, :30] = r[:, 30:60]  # exact duplicates: ties to the lowest index
    q[:, ::7] = r[:, rng.integers(0, M, len(q[0, ::7]))]
    ids = np.stack([rng.permutation(N_SRC)[:N_BUF] for _ in range(B)])
    return (torch.from_numpy(q), torch.from_numpy(r),
            torch.from_numpy(ids.astype(np.int32)))


@pytest.mark.parametrize("k", [3, 17])
@pytest.mark.parametrize("B,counts", [
    (1, [0]), (1, [N_BUF]), (1, [200]),
    (3, [0, 129, N_BUF]), (3, [37, 256, 255])])
def test_predicated_plain_twin(B, counts, k):
    q, r, ids = clouds(B, seed=sum(counts) + k)
    count = torch.tensor(counts, dtype=torch.int32)
    d, i = K.knn_topk_plain(q, r, k, row_ids=ids, count=count)
    gathered = torch.gather(q, 1, ids.long()[..., None].expand(B, N_BUF, 3))
    d_all, i_all = K.knn_topk_plain(gathered, r, k)
    assert d.shape == (B, N_BUF, k) and i.dtype == torch.int32
    for b, n in enumerate(counts):
        assert torch.equal(i[b, :n], i_all[b, :n])
        assert torch.equal(d[b, :n].view(torch.int32),
                           d_all[b, :n].view(torch.int32))
        assert (d[b, n:] == 1e30).all() and (i[b, n:] == 0).all()


@pytest.mark.parametrize("k", [3, 17])
@pytest.mark.parametrize("B,counts", [
    (1, [0]), (1, [N_BUF]), (3, [0, 129, N_BUF]), (3, [37, 256, 255])])
def test_f32packed_predicated_plain_twin(B, counts, k):
    """The f32-packed kernel's plain twin with the count on the device (the
    kd-grid's inexact fallback): its keys below each count are the
    unpredicated keys of the gathered rows, the start key 1e30 past it; the
    decoding wrapper gives the gathered rows' neighbours below the count."""
    q, r, ids = clouds(B, seed=sum(counts) + k + 1)
    count = torch.tensor(counts, dtype=torch.int32)
    keys = P.knn_f32packed_keys_plain(q, r, k, 2048, ids, count)
    gathered = torch.gather(q, 1, ids.long()[..., None].expand(B, N_BUF, 3))
    keys_all = P.knn_f32packed_keys_plain(gathered, r, k, 2048)
    d, i = P.knn_f32packed(q, r, k, tr=2048, row_ids=ids, count=count)
    d_all, i_all = P.knn_f32packed(gathered, r, k, tr=2048)
    assert keys.shape == (B, N_BUF, k) and keys.dtype == torch.float32
    for b, n in enumerate(counts):
        assert torch.equal(keys[b, :n].view(torch.int32),
                           keys_all[b, :n].view(torch.int32))
        assert (keys[b, n:] == 1e30).all()
        assert torch.equal(i[b, :n], i_all[b, :n])
        assert torch.equal(d[b, :n], d_all[b, :n])


def test_row_ids_are_clipped_and_count_bounded():
    """Ids outside the cloud's rows read its nearest edge row, as the
    kernel clips them; a count above the buffer computes every row."""
    q, r, ids = clouds(1, seed=3)
    ids[0, :4] = torch.tensor([-5, N_SRC, N_SRC + 9, 0], dtype=torch.int32)
    d, i = K.knn_topk_plain(q, r, 3, row_ids=ids,
                            count=torch.tensor([N_BUF + 50],
                                               dtype=torch.int32))
    want_rows = q[0, [0, N_SRC - 1, N_SRC - 1, 0]][None]
    d_w, i_w = K.knn_topk_plain(want_rows, r, 3)
    assert torch.equal(i[:, :4], i_w) and torch.equal(d[:, :4], d_w)
    assert (d < 1e30).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "count"])
def test_wrapper_refuses_bad_rows(bad):
    """The CUDA wrapper's checks of ``row_ids`` and ``count`` (run before
    any launch, so they are reached on the CPU)."""
    ids = torch.zeros((2, 10), dtype=torch.int32)
    count = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        ids = ids.long()
    elif bad == "shape":
        ids = ids[:1]
    else:
        count = count[:1]
    with pytest.raises(ValueError):
        K._check_rows(ids, count, 2, torch.device("cpu"))
