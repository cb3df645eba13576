"""Equal-count kd-grid kNN: exact k nearest neighbours that only visit the
candidates near each query (counterpart of
``pointcloud_style_transfer_tpu/ops/grid_knn.py``).

1. Refs sort by x into ``Sx`` slabs of equal count, each slab by y into
   ``Sy`` rows, each row by z into ``Sz`` cells (``_build_struct``). All cell
   starts are integer functions of (M, Sx, Sy, Sz) (``_partition_tables``).
2. Queries find their cell by boundary comparisons, sort by cell and are laid
   out row by row, each row padded to a multiple of ``tq`` (``_layout_slots``),
   so that a tile of ``tq`` queries lies in one (slab, row). Its candidates
   are a few contiguous runs of the sorted refs (the slot tables ``st``,
   ``en``): y-runs of the neighbour slabs when whole columns fit the window,
   whole columns of the neighbour (slab, row) pairs, or windowed z-runs.
3. The slot-run kernel (``ops/kernels/grid.py``, ``csrc/grid_fused.cu``)
   finds each query's k nearest candidates, and in interpolation mode their
   inverse-distance weighted values.
4. A row is provably exact when the ball of its k-th distance lies inside
   the covered region (the margins in ``_query_pass``). Other rows are
   recomputed by the brute-force kernel (``ops/kernels/knn.py``): only those
   rows, or every row once they outnumber the last tier of
   ``_fallback_caps``, as the TPU's ``lax.switch`` ladder does.

The TPU path's devices for its memory (one-hot matmul lookups, sorts that
stand for scatters, float-valued query ids, 128-aligned kernel windows,
padded patch buffers) are plain indexing and scatters here; they change no
result. The number of rows each pass could not prove exact is kept in
``UNSAFE_COUNTS`` (one entry per pass, the latest 4,096).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels import grid_interp, grid_topk, knn_f32packed, knn_topk
from .kernels.knn_packed import MAX_REFS, padded_refs

_FAR = 1e15  # padding coordinate of queries and refs
_INF = 3e38  # open domain edges of the boundary tables
_LANE = 128  # the slot-window granularity of the grid's tables

# rows each grid pass could not prove exact, one entry per pass
UNSAFE_COUNTS: collections.deque = collections.deque(maxlen=4096)


class GridStruct(NamedTuple):
    """The grid over one ref set, in the JAX package's tuple order."""
    refs_pad: torch.Tensor   # [M_pad, 3] sorted refs, padding at _FAR
    order_r: torch.Tensor    # [M] sorted position -> original ref id
    xb: torch.Tensor         # [Sx-1] inner slab boundaries
    yb: torch.Tensor         # [Sx, Sy-1] inner row boundaries
    zb: torch.Tensor         # [R, Sz-1] inner cell boundaries (0 if skipped)
    xb_full: torch.Tensor    # [Sx+1] with -inf/+inf edges
    yb_full: torch.Tensor    # [Sx, Sy+1]
    zb_full: torch.Tensor    # [R, Sz+1]
    CS: torch.Tensor         # [Sx*Sy*Sz+1] cell starts
    M: int
    M_pad: int


def _partition_tables(M: int, Sx: int, Sy: int, Sz: int):
    """Static partition of M sorted refs into Sx*Sy*Sz equal-count cells:
    (SB [Sx+1] slab starts, RB [Sx, Sy+1] row starts, CS [Sx*Sy*Sz+1] cell
    starts, slab_of_pos [M], row_of_pos [M]), all numpy."""
    SB = (np.arange(Sx + 1) * M) // Sx
    RB = SB[:-1, None] + (np.arange(Sy + 1)[None, :]
                          * (SB[1:] - SB[:-1])[:, None]) // Sy
    row_len = RB[:, 1:] - RB[:, :-1]
    CS = (RB[:, :-1, None]
          + (np.arange(Sz + 1)[None, None, :] * row_len[:, :, None]) // Sz)
    CS = np.concatenate([CS[:, :, :-1].reshape(-1), [M]]).astype(np.int32)
    slab_of_pos = np.repeat(np.arange(Sx), SB[1:] - SB[:-1])
    row_of_pos = np.repeat(np.arange(Sx * Sy), row_len.reshape(-1))
    return SB, RB, CS, slab_of_pos.astype(np.int32), row_of_pos.astype(np.int32)


def _full_z_ok(M: int, grid_shape, slot_cap: int) -> bool:
    """Whether every (slab, row) column fits a slot window (longest row +
    127 <= slot_cap): then slots cover whole columns and the z sort is not
    needed."""
    Sx, Sy, Sz = grid_shape
    _, RB, _, _, _ = _partition_tables(M, Sx, Sy, Sz)
    return int(np.max(RB[:, 1:] - RB[:, :-1])) + (_LANE - 1) <= slot_cap


@functools.lru_cache(maxsize=16)
def _device_tables(M: int, grid_shape, device: torch.device) -> dict:
    """``_partition_tables``' arrays as int64 tensors on ``device``, built
    once per (M, grid_shape, device): a copy from pageable host memory
    synchronises the stream, which a per-step rebuild would pay each
    time."""
    Sx, Sy, Sz = grid_shape
    SB, RB, CS, slab_pos, row_pos = _partition_tables(M, Sx, Sy, Sz)
    tables = dict(SB_inner=SB[1:-1], RB_inner=RB[:, 1:-1], CS=CS,
                  slab_pos=slab_pos, row_pos=row_pos,
                  zcs_inner=CS[:-1].reshape(Sx * Sy, Sz)[:, 1:])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in tables.items()}


def _stable_argsort_2key(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (k1, k2), ties in input order: a stable sort
    on the second key, then on the first."""
    o = torch.sort(k2, stable=True).indices
    return o[torch.sort(k1[o], stable=True).indices]


def _build_ref_structure(ref: torch.Tensor, grid_shape,
                         skip_z_sort: bool = False):
    """Sort refs into the equal-count structure: (refs_s [M, 3], order_r [M],
    xb, yb, zb, CS). ``skip_z_sort`` (sound only when every query pass
    covers whole columns) leaves rows in y order with a zero zb."""
    Sx, Sy, Sz = grid_shape
    R = Sx * Sy
    tab = _device_tables(ref.shape[0], tuple(grid_shape), ref.device)
    xr, yr, zr = ref[:, 0], ref[:, 1], ref[:, 2]
    x1, i1 = torch.sort(xr, stable=True)
    i2 = i1[_stable_argsort_2key(tab["slab_pos"], yr[i1])]
    y2 = yr[i2]
    xb = x1[tab["SB_inner"]]
    yb = y2[tab["RB_inner"]]
    if skip_z_sort:
        return ref[i2], i2, xb, yb, ref.new_zeros((R, Sz - 1)), tab["CS"]
    i3 = i2[_stable_argsort_2key(tab["row_pos"], zr[i2])]
    zb = zr[i3][tab["zcs_inner"]]
    return ref[i3], i3, xb, yb, zb, tab["CS"]


def _build_struct(ref: torch.Tensor, grid_shape,
                  skip_z_sort: bool = False) -> GridStruct:
    """The grid structure of one ref set [M, 3] float32 (see GridStruct)."""
    Sx, Sy, Sz = grid_shape
    M = ref.shape[0]
    R = Sx * Sy
    refs_s, order_r, xb, yb, zb, CS = _build_ref_structure(
        ref, grid_shape, skip_z_sort)
    M_pad = -(-M // _LANE) * _LANE
    refs_pad = torch.cat([refs_s, refs_s.new_full((M_pad - M, 3), _FAR)])
    inf = ref.new_full((1,), _INF)
    xb_full = torch.cat([-inf, xb, inf])
    yb_full = torch.cat([(-inf).expand(Sx, 1), yb, inf.expand(Sx, 1)], dim=1)
    zb_full = torch.cat([(-inf).expand(R, 1), zb, inf.expand(R, 1)], dim=1)
    return GridStruct(refs_pad.contiguous(), order_r, xb, yb, zb, xb_full,
                      yb_full, zb_full, CS, M, M_pad)


class Slots(NamedTuple):
    """A query pass's tile layout and slot tables, with what its margins
    read."""
    q_pad: torch.Tensor      # [NP, 3] row-padded queries, padding at _FAR
    orig_pad: torch.Tensor   # [NP] query id per position, Nq on padding
    real: torch.Tensor       # [T, tq] real (non-padding) positions
    n_real: torch.Tensor     # [T] int32 real rows per tile (a prefix)
    st: torch.Tensor         # [T, S] int32 run starts (sorted positions)
    en: torch.Tensor         # [T, S] int32 run ends
    tile_ok: torch.Tensor    # [T] every run fits its window
    full_z: bool
    halo: tuple              # (Hx, Hy)
    tsx: torch.Tensor        # [T] the tile's slab
    sx3c: torch.Tensor       # [T, 2Hx+1] neighbour slabs, clipped
    slab3_ok: torch.Tensor   # [T, 2Hx+1] neighbour slab exists
    r3: torch.Tensor         # [T, 2Hx+1] row of the tile's y-centre there
    pairs: Optional[tuple]   # windowed mode: (sx2, sy2, row2, zlo, zhi,
    #                          valid_pair), else None


def _layout_slots(struct: GridStruct, query: torch.Tensor, grid_shape,
                  tq: int, slot_cap: int, z_halo: int = 2, xy_halo=1,
                  full_z: Optional[bool] = None) -> Slots:
    """Lay the queries out in row-padded tiles and build each tile's slot
    runs (``_query_pass`` up to its kernel call, op for op)."""
    Sx, Sy, Sz = grid_shape
    Nq = query.shape[0]
    R = Sx * Sy
    bps = slot_cap // _LANE
    s = struct
    dev = query.device
    query = query.float()
    full_z_ok = _full_z_ok(s.M, grid_shape, slot_cap)
    if full_z is None:
        full_z = full_z_ok
    elif full_z and not full_z_ok:
        raise ValueError(
            f"full_z requires max row length + {_LANE - 1} <= slot_cap "
            f"{slot_cap} (M={s.M}, grid_shape={grid_shape})")

    # --- query cells ---
    qsx = (query[:, 0:1] >= s.xb[None, :]).sum(1)
    qsy = (query[:, 1:2] >= s.yb[qsx]).sum(1)
    qrow = qsx * Sy + qsy
    if full_z:
        qsz = torch.zeros_like(qrow)
    else:
        qsz = (query[:, 2:3] >= s.zb[qrow]).sum(1)

    # --- row-padded layout ---
    ck_s, oq = torch.sort(qrow * Sz + qsz, stable=True)
    row_s = ck_s // Sz
    rowstart = torch.searchsorted(row_s, torch.arange(R + 1, device=dev))
    counts = rowstart[1:] - rowstart[:-1]
    pcounts = -(-counts // tq) * tq
    prowstart = torch.cat([counts.new_zeros(1), torch.cumsum(pcounts, 0)])
    NP = -(-(Nq + R * tq) // tq) * tq  # static bound on the padded length
    T = NP // tq
    trow_all = torch.searchsorted(
        prowstart, torch.arange(T, device=dev) * tq, right=True) - 1
    trow = trow_all.clamp(0, R - 1)
    in_rows = (trow_all < R) & (trow_all >= 0)
    src = (torch.arange(NP, device=dev).reshape(T, tq)
           - (prowstart[trow] - rowstart[trow])[:, None])
    valid = (src < rowstart[trow + 1][:, None]) & in_rows[:, None]
    src = src.clamp(0, Nq - 1).reshape(-1)
    vflat = valid.reshape(-1)
    q_pad = torch.where(vflat[:, None], query[oq[src]],
                        query.new_full((1, 3), _FAR)).contiguous()
    orig_pad = torch.where(vflat, oq[src], Nq)

    # --- per-tile value ranges over real queries ---
    qt = q_pad.reshape(T, tq, 3)
    # a tile lies in one row and the row's padding ends it, so its real
    # rows are its first n_real: the kernels scan no padding row
    n_real = valid.sum(1, dtype=torch.int32)
    empty_t = n_real == 0
    vymin = torch.where(valid, qt[:, :, 1], _INF).amin(1)
    vymax = torch.where(valid, qt[:, :, 1], -_INF).amax(1)
    yc = torch.where(empty_t, 0.0, (vymin + vymax) * 0.5)
    if not full_z:
        vzmin = torch.where(empty_t, 0.0,
                            torch.where(valid, qt[:, :, 2], _INF).amin(1))
        vzmax = torch.where(empty_t, 0.0,
                            torch.where(valid, qt[:, :, 2], -_INF).amax(1))
    tsx = trow // Sy

    # --- slots ---
    Hx, Hy = (xy_halo, xy_halo) if isinstance(xy_halo, int) else xy_halo
    W1 = 2 * Hx + 1
    sx3 = tsx[:, None] + torch.arange(-Hx, Hx + 1, device=dev)[None, :]
    slab3_ok = (sx3 >= 0) & (sx3 < Sx)
    sx3c = sx3.clamp(0, Sx - 1)
    r3 = (yc[:, None, None] >= s.yb[sx3c]).sum(2)  # [T, W1]
    yrun = False
    if full_z:
        # y-run slots: a slab's rows are adjacent runs of the sorted refs,
        # so its +-Hy rows are one run, when that run fits the window
        _, RB, _, _, _ = _partition_tables(s.M, Sx, Sy, Sz)
        y_idx = np.arange(Sy)
        run_len = (RB[:, np.minimum(y_idx + Hy, Sy - 1) + 1]
                   - RB[:, np.maximum(y_idx - Hy, 0)])
        bps_yrun = -(-(int(np.max(run_len)) + _LANE - 1) // _LANE)
        yrun = (bps_yrun * _LANE <= s.M_pad
                and W1 * bps_yrun <= W1 * (2 * Hy + 1) * bps)
    CS = s.CS
    pairs = None
    if yrun:
        y_lo_r = (r3 - Hy).clamp(0, Sy - 1)
        y_hi_r = (r3 + Hy).clamp(0, Sy - 1)
        st = torch.where(slab3_ok, CS[(sx3c * Sy + y_lo_r) * Sz], 0)
        en = torch.where(slab3_ok, CS[(sx3c * Sy + y_hi_r) * Sz + Sz], 0)
        tile_ok = torch.ones(T, dtype=torch.bool, device=dev)
    else:
        offs = np.array([(dx, dy) for dx in range(-Hx, Hx + 1)
                         for dy in range(-Hy, Hy + 1)])
        dxi = torch.from_numpy(offs[:, 0] + Hx).to(dev)
        sy2 = r3[:, dxi] + torch.from_numpy(offs[:, 1]).to(dev)[None, :]
        sx2 = sx3[:, dxi]
        valid_pair = slab3_ok[:, dxi] & (sy2 >= 0) & (sy2 < Sy)
        row2 = sx2.clamp(0, Sx - 1) * Sy + sy2.clamp(0, Sy - 1)
        if full_z:
            st = torch.where(valid_pair, CS[row2 * Sz], 0)
            en = torch.where(valid_pair, CS[row2 * Sz + Sz], 0)
            tile_ok = torch.ones(T, dtype=torch.bool, device=dev)
        else:
            zb2 = s.zb[row2]  # [T, S, Sz-1]
            zlo = ((vzmin[:, None, None] >= zb2).sum(2) - z_halo).clamp(
                0, Sz - 1)
            zhi = ((vzmax[:, None, None] >= zb2).sum(2) + z_halo).clamp(
                0, Sz - 1)
            st = torch.where(valid_pair, CS[row2 * Sz + zlo], 0)
            en = torch.where(valid_pair, CS[row2 * Sz + zhi + 1], 0)
            # a run is scanned whole; the TPU kernel's 128-aligned window
            # would truncate it, so such a tile is not proved exact
            stb = (st // _LANE).clamp(0, s.M_pad // _LANE - bps)
            tile_ok = (en - stb * _LANE <= slot_cap).all(1)
            pairs = (sx2, sy2, row2, zlo, zhi, valid_pair)
    return Slots(q_pad, orig_pad, valid, n_real, st.int().contiguous(),
                 en.int().contiguous(), tile_ok, full_z, (Hx, Hy), tsx,
                 sx3c, slab3_ok, r3, pairs)


def _safe_rows(struct: GridStruct, sl: Slots, d_s: torch.Tensor, k: int,
               grid_shape) -> torch.Tensor:
    """[T, tq] rows whose k nearest candidates are provably the k nearest
    refs: the ball of the k-th distance stays inside the covered region
    (the x strip, each covered slab's y band, and in windowed mode each
    pair's z-run; all in squared distance), the tile's runs fit their
    windows and k candidates were found."""
    Sx, Sy, Sz = grid_shape
    s = struct
    Hx, Hy = sl.halo
    T, tq = sl.real.shape
    qt = sl.q_pad.reshape(T, tq, 3)
    qx_t, qy_t, qz_t = qt[:, :, 0], qt[:, :, 1], qt[:, :, 2]
    x_lo = s.xb_full[(sl.tsx - Hx).clamp(min=0)]
    x_hi = s.xb_full[(sl.tsx + Hx).clamp(max=Sx - 1) + 1]
    m_x = torch.minimum(qx_t - x_lo[:, None], x_hi[:, None] - qx_t)
    msq_x = m_x * m_x

    sXlo = s.xb_full[sl.sx3c]
    sXhi = s.xb_full[sl.sx3c + 1]
    dx_s = torch.maximum(sXlo[:, None, :] - qx_t[:, :, None],
                         qx_t[:, :, None] - sXhi[:, None, :]).clamp(min=0.0)
    y_lo_cand = s.yb_full[sl.sx3c, (sl.r3 - Hy).clamp(min=0)]
    y_hi_cand = s.yb_full[sl.sx3c, (sl.r3 + Hy).clamp(max=Sy - 1) + 1]
    my_s = torch.minimum(qy_t[:, :, None] - y_lo_cand[:, None, :],
                         y_hi_cand[:, None, :] - qy_t[:, :, None]
                         ).clamp(min=0.0)
    term_s = torch.where(sl.slab3_ok[:, None, :], dx_s * dx_s + my_s * my_s,
                         _INF)
    msq = torch.minimum(msq_x, term_s.amin(2))
    if sl.pairs is not None:
        sx2, sy2, row2, zlo, zhi, valid_pair = sl.pairs
        sx2c, sy2c = sx2.clamp(0, Sx - 1), sy2.clamp(0, Sy - 1)
        pXlo, pXhi = s.xb_full[sx2c], s.xb_full[sx2c + 1]
        pYlo, pYhi = s.yb_full[sx2c, sy2c], s.yb_full[sx2c, sy2c + 1]
        dx_p = torch.maximum(pXlo[:, None, :] - qx_t[:, :, None],
                             qx_t[:, :, None] - pXhi[:, None, :]
                             ).clamp(min=0.0)
        dy_p = torch.maximum(pYlo[:, None, :] - qy_t[:, :, None],
                             qy_t[:, :, None] - pYhi[:, None, :]
                             ).clamp(min=0.0)
        z_lo_cand = s.zb_full[row2, zlo]
        z_hi_cand = s.zb_full[row2, zhi + 1]
        mz_p = torch.minimum(qz_t[:, :, None] - z_lo_cand[:, None, :],
                             z_hi_cand[:, None, :] - qz_t[:, :, None]
                             ).clamp(min=0.0)
        term_p = torch.where(valid_pair[:, None, :],
                             dx_p * dx_p + dy_p * dy_p + mz_p * mz_p, _INF)
        msq = torch.minimum(msq, term_p.amin(2))
    d_last = d_s[:, k - 1].reshape(T, tq)
    return sl.tile_ok[:, None] & (d_last <= msq) & (d_last < 1e29)


def _query_pass(struct: GridStruct, query: torch.Tensor, k: int, grid_shape,
                tq: int, slot_cap: int, z_halo: int = 2, xy_halo=1,
                values: Optional[torch.Tensor] = None, eps: float = 1e-8,
                full_z: Optional[bool] = None, layout_out: bool = False):
    """One grid query pass against a built structure. Returns (d [Nq, k],
    ref ids [Nq, k], unsafe [Nq]) in query order, or (v [Nq, C], unsafe) in
    interpolation mode (``values`` [M, C] given). ``layout_out``
    (interpolation only) returns the padded layout instead: (v [NP, C],
    safe [NP], qid [NP] with Nq on padding, q_pad [NP, 3]). ``xy_halo`` is
    an int or (Hx, Hy)."""
    s = struct
    sl = _layout_slots(s, query, grid_shape, tq, slot_cap, z_halo, xy_halo,
                       full_z)
    if values is not None:
        v_s, d_s = grid_interp(sl.q_pad, s.refs_pad, _sorted_values(s, values),
                               sl.st, sl.en, k, eps, sl.n_real)
    else:
        d_s, gidx = grid_topk(sl.q_pad, s.refs_pad, sl.st, sl.en, k,
                              sl.n_real)
        gidx = gidx.long()
        ridx = torch.where(gidx < s.M, s.order_r[gidx.clamp(0, s.M - 1)], 0)
    safe = _safe_rows(s, sl, d_s, k, grid_shape).reshape(-1)
    if layout_out:
        assert values is not None
        return v_s, safe, sl.orig_pad, sl.q_pad
    # query order: position of each query id in the layout (padding rows,
    # all carrying id Nq, land in the dropped last slot)
    Nq = query.shape[0]
    NP = sl.orig_pad.shape[0]
    posq = sl.orig_pad.new_empty(Nq + 1).scatter_(
        0, sl.orig_pad, torch.arange(NP, device=query.device))[:Nq]
    unsafe = ~safe[posq]
    if values is not None:
        return v_s[posq], unsafe
    return d_s[posq], ridx[posq].int(), unsafe


def _sorted_values(struct: GridStruct, values: torch.Tensor) -> torch.Tensor:
    """values [M, C] in the grid's sorted order, zero-padded to M_pad."""
    v = values.float()[struct.order_r]
    return torch.cat([v, v.new_zeros((struct.M_pad - struct.M, v.shape[1]))]
                     ).contiguous()


def _fallback_caps(fallback_cap: int, Nq: int) -> list[int]:
    """The TPU path's patch-buffer tiers, strictly increasing. Only the last
    matters here: above it every row is recomputed, which can change the
    neighbour chosen between equidistant refs."""
    mults = (1, 2, 3, 4, 5, 6, 8, 12, 16)  # x fallback_cap/2
    caps = [(m * fallback_cap) // 2 for m in mults]
    caps = sorted({c for c in caps if 0 < c < Nq})
    return caps or [min(fallback_cap, Nq)]


def _brute(query: torch.Tensor, ref: torch.Tensor, k: int,
           exact: bool = True):
    """Brute-force kNN of one cloud: [n, 3] x [M, 3] -> ([n, k], [n, k]).
    The exact kernel (ties to the lowest ref index), or the f32-packed one
    when near-tie approximation is allowed (``exact=False``) and the refs,
    padded to 2,048, fit its 2^15 index budget."""
    q, r = query[None].contiguous(), ref[None].contiguous()
    if not exact and padded_refs(ref.shape[0], 2048) <= MAX_REFS:
        d, i = knn_f32packed(q, r, k, tr=2048)
    else:
        d, i = knn_topk(q, r, k)
    return d[0], i[0]


def _interp_weights(sq_d: torch.Tensor, eps: float) -> torch.Tensor:
    """Inverse-distance weights 1/(sqrt(d) + eps), normalised."""
    w = 1.0 / (torch.sqrt(sq_d.clamp(min=0.0)) + eps)
    return w / w.sum(-1, keepdim=True)


def _brute_interp(query, ref, values, k: int, eps: float) -> torch.Tensor:
    """Brute kNN + inverse-distance interpolation: [n, C]."""
    d, i = _brute(query, ref, k)
    w = _interp_weights(d, eps)
    vb = values[i.long().clamp(0, values.shape[0] - 1)]  # [n, k, C]
    return (vb * w[..., None]).sum(1)


def _apply_fallback(outs: tuple, unsafe: torch.Tensor, rows: torch.Tensor,
                    n_real: int, fallback_cap: int, brute) -> tuple:
    """Recompute the rows the grid could not prove exact with ``brute``
    (rows [n, 3] -> tuple like ``outs``): only those rows, or every row of
    ``rows`` once they outnumber the last fallback tier."""
    n_unsafe = int(unsafe.sum())  # the one host sync of a pass
    UNSAFE_COUNTS.append(n_unsafe)
    if n_unsafe > _fallback_caps(fallback_cap, n_real)[-1]:
        return brute(rows)
    if n_unsafe == 0:
        return outs
    ids = unsafe.nonzero()[:, 0]
    patch = brute(rows[ids])
    return tuple(o.index_copy(0, ids, p) for o, p in zip(outs, patch))


def _check_grid_args(slot_cap: int, Nq: int, name: str) -> None:
    if slot_cap % _LANE:
        raise ValueError(f"slot_cap must be a multiple of {_LANE}, got "
                         f"{slot_cap}")
    if Nq >= 2 ** 24:
        raise ValueError(f"{name} supports < 2^24 queries, got {Nq}")


def _grid_engages(M: int, k: int, grid_shape, slot_cap: int) -> bool:
    """The ref set is dense enough for the grid (else brute force)."""
    cells = int(np.prod(grid_shape))
    return M >= max(k, 4 * cells) and -(-M // _LANE) * _LANE >= slot_cap


def _grid_interp_single(query, ref, values, k, grid_shape, tq, slot_cap,
                        fallback_cap, z_halo, eps, xy_halo, layout: bool):
    """One cloud's grid interpolation: [Nq, C] in query order, or with
    ``layout`` (v [NP, C], qid [NP]) in the padded layout order."""
    Nq = query.shape[0]
    query, ref, values = query.float(), ref.float(), values.float()
    # whole-column slots (decided by _query_pass from the same sizes) never
    # read the z order, so the build skips that sort
    struct = _build_struct(ref, grid_shape, skip_z_sort=_full_z_ok(
        ref.shape[0], grid_shape, slot_cap))
    args = (struct, query, k, grid_shape, tq, slot_cap, z_halo, xy_halo,
            values, eps)

    def brute(rows):
        return (_brute_interp(rows, ref, values, k, eps),)
    if layout:
        v_out, safe, qid, q_pad = _query_pass(*args, layout_out=True)
        # padding positions never count as unsafe
        (v_out,) = _apply_fallback((v_out,), ~safe & (qid < Nq), q_pad, Nq,
                                   fallback_cap, brute)
        return v_out, qid.int()
    v_out, unsafe = _query_pass(*args)
    (v_out,) = _apply_fallback((v_out,), unsafe, query, Nq, fallback_cap,
                               brute)
    return v_out


def grid_knn_interpolate(query: torch.Tensor, ref: torch.Tensor,
                         values: torch.Tensor, k: int = 3, *,
                         grid_shape=(16, 12, 8), tq: int = 128,
                         slot_cap: int = 384, fallback_cap: int = 4096,
                         z_halo: int = 2, eps: float = 1e-8,
                         xy_halo=1) -> torch.Tensor:
    """Exact kNN + inverse-distance interpolation: query [B, N, 3], ref
    [B, M, 3], values [B, M, C] -> [B, N, C] float32. Clouds of a batch run
    one after another."""
    _check_grid_args(slot_cap, query.shape[1], "grid_knn_interpolate")
    k = min(k, ref.shape[1])
    if not _grid_engages(ref.shape[1], k, grid_shape, slot_cap):
        return torch.stack([
            _brute_interp(q.float(), r.float(), v.float(), k, eps)
            for q, r, v in zip(query, ref, values)])
    return torch.stack([
        _grid_interp_single(q, r, v, k, tuple(grid_shape), tq, slot_cap,
                            fallback_cap, z_halo, eps, xy_halo, False)
        for q, r, v in zip(query, ref, values)])


def grid_knn_interpolate_layout(query: torch.Tensor, ref: torch.Tensor,
                                values: torch.Tensor, k: int = 3, *,
                                grid_shape=(16, 12, 8), tq: int = 128,
                                slot_cap: int = 384, fallback_cap: int = 4096,
                                z_halo: int = 2, eps: float = 1e-8,
                                xy_halo=1):
    """One cloud's ``grid_knn_interpolate`` in the grid's layout order:
    query [Nq, 3], ref [M, 3], values [M, C] -> (v [NP, C], qid [NP] int32);
    ``v[j]`` interpolates query ``qid[j]``, each query appears once, padding
    positions carry ``qid == Nq``. On ref sets too small for the grid it is
    the brute interpolation with ``qid = arange(Nq)``."""
    if query.dim() != 2:
        raise ValueError("grid_knn_interpolate_layout is unbatched: "
                         f"query must be [Nq, 3], got {tuple(query.shape)}")
    Nq = query.shape[0]
    _check_grid_args(slot_cap, Nq, "grid_knn_interpolate_layout")
    k = min(k, ref.shape[0])
    if not _grid_engages(ref.shape[0], k, grid_shape, slot_cap):
        v = _brute_interp(query.float(), ref.float(), values.float(), k, eps)
        return v, torch.arange(Nq, dtype=torch.int32, device=query.device)
    return _grid_interp_single(query, ref, values, k, tuple(grid_shape), tq,
                               slot_cap, fallback_cap, z_halo, eps, xy_halo,
                               True)


def _grid_knn_single(query, ref, k, grid_shape, tq, slot_cap, fallback_cap,
                     z_halo, xy_halo, exact=True):
    """One cloud's grid kNN: ([Nq, k] float32, [Nq, k] int32). ``exact``
    only selects the brute-force kernel of the fallback."""
    query, ref = query.float(), ref.float()
    struct = _build_struct(ref, grid_shape, skip_z_sort=_full_z_ok(
        ref.shape[0], grid_shape, slot_cap))
    d_out, i_out, unsafe = _query_pass(struct, query, k, grid_shape, tq,
                                       slot_cap, z_halo, xy_halo)
    return _apply_fallback((d_out, i_out), unsafe, query, query.shape[0],
                           fallback_cap,
                           lambda rows: _brute(rows, ref, k, exact))


def grid_knn(query: torch.Tensor, ref: torch.Tensor, k: int = 3, *,
             grid_shape=(16, 12, 8), tq: int = 128, slot_cap: int = 384,
             fallback_cap: int = 4096, exact: bool = True, z_halo: int = 2,
             xy_halo=1) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kd-grid kNN: query [B, N, 3], ref [B, M, 3] -> (sq_dists
    [B, N, k] float32, indices [B, N, k] int32), ascending. Clouds of a batch
    run one after another. The grid pass is always exact or flagged;
    ``exact=False`` lets the brute-force fallback (and the brute force that
    small ref sets take) run the f32-packed kernel, whose choice can differ
    between near-ties."""
    _check_grid_args(slot_cap, query.shape[1], "grid_knn")
    if not _grid_engages(ref.shape[1], k, grid_shape, slot_cap):
        if exact:
            return knn_topk(query.float().contiguous(),
                            ref.float().contiguous(), k)
        outs = [_brute(q.float(), r.float(), k, exact)
                for q, r in zip(query, ref)]
    else:
        outs = [_grid_knn_single(q, r, k, tuple(grid_shape), tq, slot_cap,
                                 fallback_cap, z_halo, xy_halo, exact)
                for q, r in zip(query, ref)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
