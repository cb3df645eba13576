"""Slot-run kNN of the kd-grid: CUDA kernels + plain PyTorch versions.

Replaces ``pointcloud_style_transfer_tpu/ops/pallas/grid_fused.py::
_grid_interp_kernel`` (wrapper ``grid_interp_resident``) and
``::_grid_topk_kernel`` (``grid_topk_resident``); kernel source
``csrc/grid_fused.cu``, one library with both entry points.

Inputs: ``q_pad`` [NP, 3] tile-padded queries, NP = T * tq;
``refs_sorted`` [M_pad, 3] the grid-sorted refs; ``vals_sorted`` [M_pad, C]
their values (interpolation only); ``st``, ``en`` [T, S] int32 slot tables;
optionally ``n_real`` [T] int32, the real (non-padding) rows of each tile,
which are its first ``n_real[t]`` rows (``None``: every row is real).
The candidates of tile t are exactly the refs at the sorted positions of the
union of its runs ``[st[t, s], en[t, s])`` (the grid's runs of one tile are
disjoint). The TPU wrappers' 128-aligned window starts are a layout of its
VMEM and have no counterpart here.

Outputs: ascending squared distances d [NP, k] float32 in the kernels'
``(dx*dx + dy*dy) + dz*dz`` form, ties to the lowest sorted position, a NaN
distance never taken; a slot no candidate fills, and every slot of a row at
or past ``n_real``, holds (1e30, position 0). On the grid's own layouts that
changes no result: a padding query lies at 1e15, about 3e30 from any real
ref, so it never beats the start list. ``grid_topk`` also returns the
positions [NP, k] int32, clipped to [0, M_pad - 1]; ``grid_interp`` returns
v [NP, C] = sum_u (w_u / wsum) * vals_sorted[pos_u] with
w_u = 1 / (sqrt(max(d_u, 0)) + eps) and wsum = (w_0 + w_1) + ..., summed in
u order. A row with fewer than k candidates gets a finite, meaningless v;
the grid marks such rows unsafe and recomputes them. Any k >= 1: up to
``MAX_K`` the lists live in registers (the interpolation's above 8 only
on tiles of at most 512 rows); above it a variant of each kernel keeps
them in the output (and the interpolation's positions in a scratch), with
the same tie order.
"""

from __future__ import annotations

import torch

from ._common import launch, pairwise_sq_dist

MAX_K = 16      # lists in registers for 1 <= k <= 16; above, in the output
MAX_TQ = 1024   # one thread per query of a tile
_BIG = 1e30
# a masked (or NaN) candidate's selection key: +inf's bits, after every
# real key
_MASKED_KEY = 0x7F800000 << 32
_CHUNK_ELEMS = 1 << 23  # plain versions: distance elements per chunk


def _tile_candidates(st: torch.Tensor, en: torch.Tensor, M_pad: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, S] runs, clipped to [0, M_pad) as the kernels clip them ->
    candidate positions [T, W] int64 and their mask: slot after slot, each
    slot padded to its longest run."""
    st = st.long().clamp(min=0)
    lengths = (en.long().clamp(max=M_pad) - st).clamp(min=0)
    widths = lengths.amax(dim=0).tolist() if lengths.shape[0] else []
    pos, ok = [], []
    for s, w in enumerate(widths):
        j = torch.arange(w, device=st.device)
        pos.append(st[:, s:s + 1] + j)
        ok.append(j < lengths[:, s:s + 1])
    if not pos:
        empty = torch.zeros((st.shape[0], 0), dtype=torch.int64,
                            device=st.device)
        return empty, empty.bool()
    return torch.cat(pos, dim=1), torch.cat(ok, dim=1)


def _padding_rows(n_real: torch.Tensor | None, T: int, tq: int
                  ) -> torch.Tensor | None:
    """[T * tq] rows at or past their tile's ``n_real`` (clipped to
    [0, tq], as the kernels clip it), or None."""
    if n_real is None:
        return None
    rows = torch.arange(tq, device=n_real.device)
    return (rows[None, :] >= n_real.long().clamp(0, tq)[:, None]).reshape(-1)


def grid_topk_plain(q_pad: torch.Tensor, refs_sorted: torch.Tensor,
                    st: torch.Tensor, en: torch.Tensor, k: int,
                    n_real: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k kernel's function in plain PyTorch (CPU tensors, tests and
    the card's oracle). Selection is exact on (distance, position): one
    int64 key per candidate, float bits << 32 | position (a non-negative
    float orders like its bits; a NaN takes the masked key)."""
    q_pad = q_pad.float()
    refs_sorted = refs_sorted.float()
    T = st.shape[0]
    NP = q_pad.shape[0]
    M_pad = refs_sorted.shape[0]
    d_out = torch.full((NP, k), _BIG, dtype=torch.float32, device=q_pad.device)
    i_out = torch.zeros((NP, k), dtype=torch.int32, device=q_pad.device)
    pos, ok = _tile_candidates(st, en, M_pad)
    W = pos.shape[1]
    kk = min(k, W)
    if T == 0 or kk == 0:
        return d_out, i_out
    tq = NP // T
    pos = pos.clamp(0, M_pad - 1)
    qt = q_pad.view(T, tq, 3)
    chunk = max(1, _CHUNK_ELEMS // (tq * W))
    for a in range(0, T, chunk):
        p, m = pos[a:a + chunk], ok[a:a + chunk]
        d = pairwise_sq_dist(qt[a:a + chunk], refs_sorted[p])  # [t, tq, W]
        keys = (d.view(torch.int32).to(torch.int64) << 32) | p[:, None, :]
        keys = keys.masked_fill(~m[:, None, :] | torch.isnan(d), _MASKED_KEY)
        top = torch.topk(keys, kk, dim=2, largest=False, sorted=True).values
        dd = (top >> 32).to(torch.int32).view(torch.float32).reshape(-1, kk)
        ii = (top & 0xFFFFFFFF).to(torch.int32).reshape(-1, kk)
        taken = dd < _BIG  # the kernel inserts only below (1e30, 0)
        rows = slice(a * tq, a * tq + dd.shape[0])
        d_out[rows, :kk] = torch.where(taken, dd, _BIG)
        i_out[rows, :kk] = torch.where(taken, ii, 0)
    padding = _padding_rows(n_real, T, tq)
    if padding is not None:  # the start list, as the kernels leave it
        d_out[padding] = _BIG
        i_out[padding] = 0
    return d_out, i_out.clamp_(0, M_pad - 1)


def _interp_weighted_sum(d: torch.Tensor, pos: torch.Tensor,
                        vals: torch.Tensor, eps: float) -> torch.Tensor:
    """The interpolation kernel's epilogue: d, pos [NP, k] -> [NP, C]."""
    w = 1.0 / (torch.sqrt(torch.clamp(d, min=0.0)) + eps)
    wsum = w[:, 0]
    for u in range(1, d.shape[1]):
        wsum = wsum + w[:, u]
    p = pos.long()
    v = (w[:, 0] / wsum)[:, None] * vals[p[:, 0]]
    for u in range(1, d.shape[1]):
        v = v + (w[:, u] / wsum)[:, None] * vals[p[:, u]]
    return v


def grid_interp_plain(q_pad: torch.Tensor, refs_sorted: torch.Tensor,
                      vals_sorted: torch.Tensor, st: torch.Tensor,
                      en: torch.Tensor, k: int, eps: float = 1e-8,
                      n_real: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The interpolation kernel's function in plain PyTorch: (v, d)."""
    d, pos = grid_topk_plain(q_pad, refs_sorted, st, en, k, n_real)
    return _interp_weighted_sum(d, pos, vals_sorted.float(), eps), d


def _check(x: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_slot_inputs(q_pad, refs_sorted, st, en, k, n_real
                       ) -> tuple[int, int]:
    """Raise on what the kernels do not take; returns (T, tq)."""
    dev = q_pad.device
    _check(q_pad, "q_pad", torch.float32, 2, dev)
    _check(refs_sorted, "refs_sorted", torch.float32, 2, dev)
    _check(st, "st", torch.int32, 2, dev)
    _check(en, "en", torch.int32, 2, dev)
    if q_pad.shape[1] != 3 or refs_sorted.shape[1] != 3:
        raise ValueError("q_pad and refs_sorted must be [N, 3]")
    if st.shape != en.shape:
        raise ValueError(f"st {tuple(st.shape)} and en {tuple(en.shape)} "
                         "differ")
    if refs_sorted.shape[0] == 0:
        raise ValueError("the grid kernels need at least one ref")
    if k < 1:
        raise ValueError(f"the grid kernels take k >= 1, got {k}")
    T, NP = st.shape[0], q_pad.shape[0]
    if T == 0 or NP % T or not 1 <= NP // T <= MAX_TQ:
        raise ValueError(f"q_pad's {NP} rows must be T={T} tiles of 1 to "
                         f"{MAX_TQ} queries")
    if n_real is not None:
        _check(n_real, "n_real", torch.int32, 1, dev)
        if n_real.shape[0] != T:
            raise ValueError(f"n_real must be [{T}], got "
                             f"{tuple(n_real.shape)}")
    return T, NP // T


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def grid_interp_cuda(q_pad: torch.Tensor, refs_sorted: torch.Tensor,
                     vals_sorted: torch.Tensor, st: torch.Tensor,
                     en: torch.Tensor, k: int, eps: float = 1e-8,
                     n_real: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/grid_fused.cu``'s interpolation kernel on the current
    stream: (v [NP, C], d [NP, k])."""
    T, tq = _check_slot_inputs(q_pad, refs_sorted, st, en, k, n_real)
    _check(vals_sorted, "vals_sorted", torch.float32, 2, q_pad.device)
    M_pad, C = vals_sorted.shape
    if M_pad != refs_sorted.shape[0] or C == 0:
        raise ValueError(f"vals_sorted must be [{refs_sorted.shape[0]}, C>0], "
                         f"got {tuple(vals_sorted.shape)}")
    NP = q_pad.shape[0]
    v = torch.empty((NP, C), dtype=torch.float32, device=q_pad.device)
    d = torch.empty((NP, k), dtype=torch.float32, device=q_pad.device)
    # the global-list kernel (above MAX_K, and above 8 on tiles wider than
    # 512 rows) keeps each row's positions in a scratch
    pos = (torch.empty((NP, k), dtype=torch.int32, device=q_pad.device)
           if k > 8 else None)
    launch("grid_interp", q_pad.device, q_pad.data_ptr(),
           refs_sorted.data_ptr(), vals_sorted.data_ptr(), st.data_ptr(),
           en.data_ptr(), _ptr(n_real), v.data_ptr(), d.data_ptr(),
           _ptr(pos), T, tq, st.shape[1], M_pad, C, k, eps)
    return v, d


def grid_topk_cuda(q_pad: torch.Tensor, refs_sorted: torch.Tensor,
                   st: torch.Tensor, en: torch.Tensor, k: int,
                   n_real: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/grid_fused.cu``'s top-k kernel on the current stream:
    (d [NP, k], sorted positions [NP, k] int32)."""
    T, tq = _check_slot_inputs(q_pad, refs_sorted, st, en, k, n_real)
    NP = q_pad.shape[0]
    d = torch.empty((NP, k), dtype=torch.float32, device=q_pad.device)
    i = torch.empty((NP, k), dtype=torch.int32, device=q_pad.device)
    launch("grid_topk", q_pad.device, q_pad.data_ptr(),
           refs_sorted.data_ptr(), st.data_ptr(), en.data_ptr(),
           _ptr(n_real), d.data_ptr(), i.data_ptr(), T, tq, st.shape[1],
           refs_sorted.shape[0], k)
    return d, i


def grid_interp(q_pad, refs_sorted, vals_sorted, st, en, k: int,
                eps: float = 1e-8, n_real: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot-run kNN + interpolation: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q_pad.device.type == "cpu":
        return grid_interp_plain(q_pad, refs_sorted, vals_sorted, st, en, k,
                                 eps, n_real)
    return grid_interp_cuda(q_pad, refs_sorted, vals_sorted, st, en, k, eps,
                            n_real)


def grid_topk(q_pad, refs_sorted, st, en, k: int,
              n_real: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot-run kNN: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q_pad.device.type == "cpu":
        return grid_topk_plain(q_pad, refs_sorted, st, en, k, n_real)
    return grid_topk_cuda(q_pad, refs_sorted, st, en, k, n_real)
