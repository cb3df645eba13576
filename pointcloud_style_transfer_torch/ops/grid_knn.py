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
   ``_fallback_caps``, as the TPU's ``lax.switch`` ladder does. The ladder
   runs on the device (``_patch_rows``, ``_patched``): the unsafe count
   never reaches the host, the rows to recompute are compacted in ascending
   order into a buffer of static size (a cumsum scatter, the order of the
   TPU's one sort), and one ``knn_topk`` launch reads its row count from
   device memory, so a sampler step can be captured in a CUDA graph.

A batch of B > 1 clouds runs flat when the grid covers whole columns
(``_batched_grid_ok``), as on the TPU: one structure build over all clouds
(``_build_struct_batched``, cloud b's sorted refs at [b*M_pad, b*M_pad + M)
of one array), one layout over the B*Sx*Sy (cloud, slab, row) rows with
each tile's runs shifted into its cloud's part of the refs, one
``grid_interp`` launch, and one fallback ladder whose tier comes from the
largest per-cloud unsafe count: one brute-force launch (with a batch axis)
a group of at most ``_BATCHED_MAX_GROUP`` clouds.

The TPU path's devices for its memory (one-hot matmul lookups, sorts that
stand for scatters, float-valued query ids, 128-aligned kernel windows,
padded patch buffers) are plain indexing and scatters here; they change no
result. The number of rows each pass could not prove exact is kept in
``UNSAFE_COUNTS``: one 0-d int64 tensor on the pass's device per cloud and
pass, the latest 4,096, which ``unsafe_counts()`` reads in one host sync
after the work.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels import grid_interp, grid_topk, knn_f32packed, knn_topk
from .kernels.knn_packed import MAX_REFS, padded_refs

_FAR = 1e15  # padding coordinate of queries and refs
_INF = 3e38  # open domain edges of the boundary tables
_LANE = 128  # the slot-window granularity of the grid's tables
GRID_SHAPE = (16, 12, 8)  # the entry points' default grid
SLOT_CAP = 384  # and slot window (refs)

# rows each grid pass could not prove exact: one 0-d int64 tensor on the
# pass's device per cloud and pass, appended without a host sync
UNSAFE_COUNTS: collections.deque = collections.deque(maxlen=4096)


_RECORDERS: list = []  # the lists of open ``recording_unsafe`` blocks


def _record_unsafe(counts) -> None:
    """Keep each pass's per-cloud counts (0-d tensors): in the innermost
    ``recording_unsafe`` list, else in ``UNSAFE_COUNTS``."""
    (_RECORDERS[-1] if _RECORDERS else UNSAFE_COUNTS).extend(counts)


@contextlib.contextmanager
def recording_unsafe():
    """Within the block the passes' counts go to the list it yields, not to
    ``UNSAFE_COUNTS`` (a captured sampler stacks them inside its graph)."""
    counts: list = []
    _RECORDERS.append(counts)
    try:
        yield counts
    finally:
        _RECORDERS.pop()


def unsafe_counts() -> list[int]:
    """``UNSAFE_COUNTS`` as ints, oldest first: one host sync a device."""
    entries = list(UNSAFE_COUNTS)
    out = [0] * len(entries)
    by_device: dict = {}
    for j, t in enumerate(entries):
        by_device.setdefault(t.device, []).append(j)
    for js in by_device.values():
        for j, v in zip(js, torch.stack([entries[j] for j in js]).tolist()):
            out[j] = v
    return out


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


@functools.lru_cache(maxsize=None)
def _device_tables(M: int, grid_shape, device: torch.device) -> dict:
    """``_partition_tables``' arrays as int64 tensors on ``device``, built
    once per (M, grid_shape, device): a copy from pageable host memory
    synchronises the stream, which a per-step rebuild would pay each time
    and a CUDA graph's capture refuses. Never evicted: a captured sampler
    reads them at every replay."""
    Sx, Sy, Sz = grid_shape
    SB, RB, CS, slab_pos, row_pos = _partition_tables(M, Sx, Sy, Sz)
    tables = dict(SB_inner=SB[1:-1], RB_inner=RB[:, 1:-1], CS=CS,
                  slab_pos=slab_pos, row_pos=row_pos,
                  zcs_inner=CS[:-1].reshape(Sx * Sy, Sz)[:, 1:])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in tables.items()}


@functools.lru_cache(maxsize=None)
def _pair_offsets(Hx: int, Hy: int, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (slab, row) neighbour pairs of a tile, dx-major: (column of the
    tile's neighbour slab [P], row offset [P]) on ``device``, built once
    (cached as ``_device_tables`` is, for the same reasons)."""
    offs = np.array([(dx, dy) for dx in range(-Hx, Hx + 1)
                     for dy in range(-Hy, Hy + 1)])
    return (torch.from_numpy(offs[:, 0] + Hx).to(device),
            torch.from_numpy(offs[:, 1]).to(device))


def _stable_argsort_2key(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (k1, k2) along k2's last axis, ties in input
    order: a stable sort on the second key, then on the first (``k1`` [M]
    holds the first key of each position, shared by every row of k2)."""
    o = torch.sort(k2, dim=-1, stable=True).indices
    return torch.gather(o, -1, torch.sort(k1[o], dim=-1, stable=True).indices)


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


class GridStructBatched(NamedTuple):
    """The grids over B ref sets of M refs each, built together with whole
    columns (no z order): cloud b's sorted refs at [b*M_pad, b*M_pad + M)
    of one array, ``_FAR`` padding between the clouds. The JAX package's
    tuple order, then the cell starts (a constant there)."""
    refs_pad: torch.Tensor   # [B*M_pad, 3]
    order_g: torch.Tensor    # [B*M] sorted position -> global ref id b*M + i
    xb: torch.Tensor         # [B, Sx-1]
    yb: torch.Tensor         # [B, Sx, Sy-1]
    xb_full: torch.Tensor    # [B, Sx+1]
    yb_full: torch.Tensor    # [B, Sx, Sy+1]
    M: int
    M_pad: int
    CS: torch.Tensor         # [Sx*Sy*Sz+1] cell starts of one cloud


def _build_struct_batched(ref: torch.Tensor, grid_shape) -> GridStructBatched:
    """The grids of B ref sets [B, M, 3] float32 in one build: each sort
    runs over every cloud at once along the point axis, which orders like
    the TPU's composite (cloud, key) sorts over [B*M]; each cloud's order is
    that of its own ``_build_struct(..., skip_z_sort=True)``."""
    Sx, Sy, _ = grid_shape
    B, M, _ = ref.shape
    tab = _device_tables(M, tuple(grid_shape), ref.device)
    x1, i1 = torch.sort(ref[..., 0], dim=1, stable=True)
    i2 = torch.gather(i1, 1, _stable_argsort_2key(
        tab["slab_pos"], torch.gather(ref[..., 1], 1, i1)))
    y2 = torch.gather(ref[..., 1], 1, i2)
    xb = x1[:, tab["SB_inner"]]
    yb = y2[:, tab["RB_inner"]]
    M_pad = -(-M // _LANE) * _LANE
    refs_s = torch.gather(ref, 1, i2[..., None].expand(B, M, 3))
    refs_pad = torch.cat([refs_s, refs_s.new_full((B, M_pad - M, 3), _FAR)],
                         dim=1).reshape(B * M_pad, 3)
    inf = ref.new_full((B, 1), _INF)
    xb_full = torch.cat([-inf, xb, inf], dim=1)
    yb_full = torch.cat([(-inf)[:, None].expand(B, Sx, 1), yb,
                         inf[:, None].expand(B, Sx, 1)], dim=2)
    order_g = (i2 + torch.arange(B, device=ref.device)[:, None] * M
               ).reshape(-1)
    return GridStructBatched(refs_pad.contiguous(), order_g, xb, yb, xb_full,
                             yb_full, M, M_pad, tab["CS"])


def _at(table: torch.Tensor, tb: Optional[torch.Tensor], *idx):
    """``table[tb, *idx]``: a batched grid's table of the tile's cloud
    ``tb``; with ``tb`` None a one-cloud table, indexed as it is."""
    return table[idx] if tb is None else table[(tb,) + idx]


class Slots(NamedTuple):
    """A query pass's tile layout and slot tables, with what its margins
    read."""
    q_pad: torch.Tensor      # [NP, 3] row-padded queries, padding at _FAR
    orig_pad: torch.Tensor   # [NP] query id per position, B*Nq on padding
    real: torch.Tensor       # [T, tq] real (non-padding) positions
    n_real: torch.Tensor     # [T] int32 real rows per tile (a prefix)
    st: torch.Tensor         # [T, S] int32 run starts (sorted positions)
    en: torch.Tensor         # [T, S] int32 run ends
    tile_ok: torch.Tensor    # [T] every run fits its window
    full_z: bool
    halo: tuple              # (Hx, Hy)
    tb: Optional[torch.Tensor]  # [T] the tile's cloud; None for one cloud
    tsx: torch.Tensor        # [T] the tile's slab
    sx3c: torch.Tensor       # [T, 2Hx+1] neighbour slabs, clipped
    slab3_ok: torch.Tensor   # [T, 2Hx+1] neighbour slab exists
    r3: torch.Tensor         # [T, 2Hx+1] row of the tile's y-centre there
    pairs: Optional[tuple]   # windowed mode: (sx2, sy2, row2, zlo, zhi,
    #                          valid_pair), else None


def _layout_slots(struct, query: torch.Tensor, grid_shape,
                  tq: int, slot_cap: int, z_halo: int = 2, xy_halo=1,
                  full_z: Optional[bool] = None) -> Slots:
    """Lay the queries out in row-padded tiles and build each tile's slot
    runs (``_query_pass`` up to its kernel call, op for op). ``query`` is
    [Nq, 3] against a ``GridStruct``, or [B, Nq, 3] against a
    ``GridStructBatched``: then one layout covers the B*Sx*Sy (cloud, slab,
    row) rows, query ids are b*Nq + i, and a tile's runs are shifted into
    its cloud's part of the refs (whole columns only)."""
    Sx, Sy, Sz = grid_shape
    s = struct
    batched = isinstance(s, GridStructBatched)
    dev = query.device
    # one cloud's tables are indexed as they are: no cloud arithmetic
    qb = query.float() if batched else query.float()[None]
    B, Nq = qb.shape[:2]
    Ng = B * Nq
    R = Sx * Sy
    Rg = B * R
    bps = slot_cap // _LANE
    full_z_ok = _full_z_ok(s.M, grid_shape, slot_cap)
    if full_z is None:
        full_z = full_z_ok
    elif full_z and not full_z_ok:
        raise ValueError(
            f"full_z requires max row length + {_LANE - 1} <= slot_cap "
            f"{slot_cap} (M={s.M}, grid_shape={grid_shape})")
    if batched and not full_z:
        raise ValueError("the batched grid pass requires whole-column slots "
                         f"(M={s.M}, grid_shape={grid_shape}, "
                         f"slot_cap={slot_cap})")

    # --- query cells (global rows: cloud * R + slab * Sy + row) ---
    cloud = torch.arange(B, device=dev)[:, None] if batched else None
    xb = s.xb if batched else s.xb[None]
    qsx = (qb[..., 0:1] >= xb[:, None, :]).sum(2)  # [B, Nq]
    qsy = (qb[..., 1:2] >= _at(s.yb, cloud, qsx)).sum(2)
    qrow = qsx * Sy + qsy
    if full_z:
        qsz = torch.zeros_like(qrow)
    else:
        qsz = (qb[..., 2:3] >= s.zb[qrow]).sum(2)
    grow = cloud * R + qrow if batched else qrow

    # --- row-padded layout ---
    ck_s, oq = torch.sort((grow * Sz + qsz).reshape(-1), stable=True)
    row_s = ck_s // Sz
    rowstart = torch.searchsorted(row_s, torch.arange(Rg + 1, device=dev))
    counts = rowstart[1:] - rowstart[:-1]
    pcounts = -(-counts // tq) * tq
    prowstart = torch.cat([counts.new_zeros(1), torch.cumsum(pcounts, 0)])
    NP = -(-(Ng + Rg * tq) // tq) * tq  # static bound on the padded length
    T = NP // tq
    trow_all = torch.searchsorted(
        prowstart, torch.arange(T, device=dev) * tq, right=True) - 1
    trow = trow_all.clamp(0, Rg - 1)
    in_rows = (trow_all < Rg) & (trow_all >= 0)
    src = (torch.arange(NP, device=dev).reshape(T, tq)
           - (prowstart[trow] - rowstart[trow])[:, None])
    valid = (src < rowstart[trow + 1][:, None]) & in_rows[:, None]
    src = src.clamp(0, Ng - 1).reshape(-1)
    vflat = valid.reshape(-1)
    q_pad = torch.where(vflat[:, None], qb.reshape(Ng, 3)[oq[src]],
                        qb.new_full((1, 3), _FAR)).contiguous()
    orig_pad = torch.where(vflat, oq[src], Ng)

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
    # a tile never straddles clouds
    tb, tsx = (trow // R, (trow % R) // Sy) if batched else (None, trow // Sy)
    tb2 = None if tb is None else tb[:, None]

    # --- slots, shifted into the tile's cloud's part of the refs ---
    Hx, Hy = (xy_halo, xy_halo) if isinstance(xy_halo, int) else xy_halo
    W1 = 2 * Hx + 1
    sx3 = tsx[:, None] + torch.arange(-Hx, Hx + 1, device=dev)[None, :]
    slab3_ok = (sx3 >= 0) & (sx3 < Sx)
    sx3c = sx3.clamp(0, Sx - 1)
    r3 = (yc[:, None, None] >= _at(s.yb, tb2, sx3c)).sum(2)  # [T, W1]

    def shift(pos):  # into the tile's cloud's part of the refs
        return pos if tb is None else pos + tb2 * s.M_pad
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
        st = torch.where(slab3_ok, shift(CS[(sx3c * Sy + y_lo_r) * Sz]), 0)
        en = torch.where(slab3_ok,
                         shift(CS[(sx3c * Sy + y_hi_r) * Sz + Sz]), 0)
        tile_ok = torch.ones(T, dtype=torch.bool, device=dev)
    else:
        dxi, dyo = _pair_offsets(Hx, Hy, dev)
        sy2 = r3[:, dxi] + dyo[None, :]
        sx2 = sx3[:, dxi]
        valid_pair = slab3_ok[:, dxi] & (sy2 >= 0) & (sy2 < Sy)
        row2 = sx2.clamp(0, Sx - 1) * Sy + sy2.clamp(0, Sy - 1)
        if full_z:
            st = torch.where(valid_pair, shift(CS[row2 * Sz]), 0)
            en = torch.where(valid_pair, shift(CS[row2 * Sz + Sz]), 0)
            tile_ok = torch.ones(T, dtype=torch.bool, device=dev)
        else:  # one cloud: the batched pass takes whole columns only
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
                 en.int().contiguous(), tile_ok, full_z, (Hx, Hy), tb, tsx,
                 sx3c, slab3_ok, r3, pairs)


def _safe_rows(struct, sl: Slots, d_s: torch.Tensor, k: int, grid_shape,
               diag: bool = False):
    """[T, tq] rows whose k nearest candidates are provably the k nearest
    refs: the ball of the k-th distance stays inside the covered region
    (the x strip, each covered slab's y band, and in windowed mode each
    pair's z-run; all in squared distance), the tile's runs fit their
    windows and k candidates were found. Each tile reads its own cloud's
    boundary tables. ``diag`` also returns the margin terms ([T, tq] each:
    ``msq_x``, ``msq_slab``, ``msq_pair`` (inf with whole columns),
    ``d_last``, ``tile_ok``)."""
    Sx, Sy, Sz = grid_shape
    s = struct
    xb_full, yb_full = s.xb_full, s.yb_full
    Hx, Hy = sl.halo
    T, tq = sl.real.shape
    tb = sl.tb
    tb2 = None if tb is None else tb[:, None]
    qt = sl.q_pad.reshape(T, tq, 3)
    qx_t, qy_t, qz_t = qt[:, :, 0], qt[:, :, 1], qt[:, :, 2]
    x_lo = _at(xb_full, tb, (sl.tsx - Hx).clamp(min=0))
    x_hi = _at(xb_full, tb, (sl.tsx + Hx).clamp(max=Sx - 1) + 1)
    m_x = torch.minimum(qx_t - x_lo[:, None], x_hi[:, None] - qx_t)
    msq_x = m_x * m_x

    sXlo = _at(xb_full, tb2, sl.sx3c)
    sXhi = _at(xb_full, tb2, sl.sx3c + 1)
    dx_s = torch.maximum(sXlo[:, None, :] - qx_t[:, :, None],
                         qx_t[:, :, None] - sXhi[:, None, :]).clamp(min=0.0)
    y_lo_cand = _at(yb_full, tb2, sl.sx3c, (sl.r3 - Hy).clamp(min=0))
    y_hi_cand = _at(yb_full, tb2, sl.sx3c,
                    (sl.r3 + Hy).clamp(max=Sy - 1) + 1)
    my_s = torch.minimum(qy_t[:, :, None] - y_lo_cand[:, None, :],
                         y_hi_cand[:, None, :] - qy_t[:, :, None]
                         ).clamp(min=0.0)
    term_s = torch.where(sl.slab3_ok[:, None, :], dx_s * dx_s + my_s * my_s,
                         _INF)
    msq_slab = term_s.amin(2)
    msq = torch.minimum(msq_x, msq_slab)
    msq_pair = None
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
        msq_pair = term_p.amin(2)
        msq = torch.minimum(msq, msq_pair)
    d_last = d_s[:, k - 1].reshape(T, tq)
    safe = sl.tile_ok[:, None] & (d_last <= msq) & (d_last < 1e29)
    if not diag:
        return safe
    return safe, {
        "msq_x": msq_x, "msq_slab": msq_slab,
        "msq_pair": (torch.full_like(msq_x, _INF) if msq_pair is None
                     else msq_pair),
        "d_last": d_last, "tile_ok": sl.tile_ok[:, None].expand(T, tq)}


def _query_pass(struct, query: torch.Tensor, k: int, grid_shape,
                tq: int, slot_cap: int, z_halo: int = 2, xy_halo=1,
                values: Optional[torch.Tensor] = None, eps: float = 1e-8,
                full_z: Optional[bool] = None, layout_out: bool = False,
                diag: bool = False):
    """One grid query pass against a built structure. Returns (d [Nq, k],
    ref ids [Nq, k], unsafe [Nq]) in query order, or (v [Nq, C], unsafe) in
    interpolation mode (``values`` [M, C] given). ``layout_out``
    (interpolation only) returns the padded layout instead: (v [NP, C],
    safe [NP], qid [NP] with Nq on padding, q_pad [NP, 3]). ``diag`` (not
    with ``layout_out``) appends a dict of the margin terms in query order
    (see ``_safe_rows``). ``xy_halo`` is an int or (Hx, Hy). A
    ``GridStructBatched`` takes [B, Nq, 3] queries and [B, M, C] values in
    layout mode only: one ``grid_interp`` launch over every cloud's tiles,
    qid the global query ids b*Nq + i with B*Nq on padding."""
    s = struct
    if isinstance(s, GridStructBatched) and not (
            layout_out and values is not None):
        raise ValueError("a batched grid pass runs the interpolation in "
                         "layout order only")
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
    safe = _safe_rows(s, sl, d_s, k, grid_shape, diag)
    if diag:
        safe, terms = safe
    safe = safe.reshape(-1)
    if layout_out:
        assert values is not None and not diag
        return v_s, safe, sl.orig_pad, sl.q_pad
    # query order: position of each query id in the layout (padding rows,
    # all carrying id Nq, land in the dropped last slot)
    Nq = query.shape[0]
    NP = sl.orig_pad.shape[0]
    posq = sl.orig_pad.new_empty(Nq + 1).scatter_(
        0, sl.orig_pad, torch.arange(NP, device=query.device))[:Nq]
    unsafe = ~safe[posq]
    out = ((v_s[posq], unsafe) if values is not None
           else (d_s[posq], ridx[posq].int(), unsafe))
    if diag:
        out += ({n: t.reshape(-1)[posq] for n, t in terms.items()},)
    return out


def _sorted_values(struct, values: torch.Tensor) -> torch.Tensor:
    """values [M, C] ([B, M, C] for a batched grid) in the grid's sorted
    order, zero-padded to M_pad a cloud."""
    s = struct
    if isinstance(s, GridStructBatched):
        B, M, C = values.shape
        v = values.float().reshape(B * M, C)[s.order_g].reshape(B, M, C)
        return torch.cat([v, v.new_zeros((B, s.M_pad - M, C))], dim=1
                         ).reshape(B * s.M_pad, C).contiguous()
    v = values.float()[s.order_r]
    return torch.cat([v, v.new_zeros((s.M_pad - s.M, v.shape[1]))]
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
           exact: bool = True, row_ids: Optional[torch.Tensor] = None,
           count: Optional[torch.Tensor] = None,
           plan_rows: Optional[int] = None):
    """Brute-force kNN of one cloud: [Nsrc, 3] x [M, 3] -> ([n, k], [n, k]).
    The exact kernel (ties to the lowest ref index), or the f32-packed one
    when near-tie approximation is allowed (``exact=False``) and the refs,
    padded to 2,048, fit its 2^15 index budget. ``row_ids`` [1, n] and
    ``count`` [1] (``_patch_rows``) pick the rows: either kernel computes
    only the counted ones, planned for ``plan_rows`` of them."""
    q, r = query[None].contiguous(), ref[None].contiguous()
    if not exact and padded_refs(ref.shape[0], 2048) <= MAX_REFS:
        d, i = knn_f32packed(q, r, k, tr=2048, row_ids=row_ids, count=count,
                             plan_rows=plan_rows)
    else:
        d, i = knn_topk(q, r, k, row_ids=row_ids, count=count,
                        plan_rows=plan_rows)
    return d[0], i[0]


def _interp_weights(sq_d: torch.Tensor, eps: float) -> torch.Tensor:
    """Inverse-distance weights 1/(sqrt(d) + eps), normalised."""
    w = 1.0 / (torch.sqrt(sq_d.clamp(min=0.0)) + eps)
    return w / w.sum(-1, keepdim=True)


def _brute_interp_batched(query, ref, values, k: int, eps: float,
                          row_ids: Optional[torch.Tensor] = None,
                          count: Optional[torch.Tensor] = None,
                          plan_rows: Optional[int] = None) -> torch.Tensor:
    """Brute kNN (the exact kernel, one launch for the batch) + inverse-
    distance interpolation: [B, n, 3] x [B, M, 3], [B, M, C] -> [B, n, C].
    ``row_ids`` [B, n] and ``count`` [B] as ``knn_topk`` takes them."""
    d, i = knn_topk(query.contiguous(), ref.contiguous(), k, row_ids=row_ids,
                    count=count, plan_rows=plan_rows)
    w = _interp_weights(d, eps)
    B, n = d.shape[:2]
    M, C = values.shape[1:]
    idx = i.long().clamp(0, M - 1).reshape(B, n * k, 1).expand(B, n * k, C)
    vb = torch.gather(values, 1, idx).reshape(B, n, k, C)
    return (vb * w[..., None]).sum(2)


def _brute_interp(query, ref, values, k: int, eps: float,
                  row_ids: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None,
                  plan_rows: Optional[int] = None) -> torch.Tensor:
    """Brute kNN + inverse-distance interpolation of one cloud: [n, C]."""
    d, i = _brute(query, ref, k, True, row_ids, count, plan_rows)
    w = _interp_weights(d, eps)
    vb = values[i.long().clamp(0, values.shape[0] - 1)]  # [n, k, C]
    return (vb * w[..., None]).sum(1)


def _patch_plan_rows(fallback_cap: int) -> int:
    """The rows a cloud's patch launch is planned for: the ladder's first
    tier, ``fallback_cap / 2`` (a ``Config()`` step leaves ~1,500-2,500
    unsafe rows, PERF.md), whatever the count the device finds."""
    return max(fallback_cap // 2, 1)


def _patch_rows(unsafe: torch.Tensor, all_brute: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ladder's rows on the device: unsafe [B, n] bool and the
    all-brute tier ``all_brute`` (a bool tensor) -> (row_ids [B, n] int32,
    count [B] int32). Each cloud's unsafe rows in ascending order, or in
    the all-brute tier every row, at the front of a buffer of static size n
    (a cumsum scatter, which orders the rows as the TPU's one sort of
    ``where(unsafe, iota, n)`` does); the slots past the count hold n."""
    B, n = unsafe.shape
    take = unsafe | all_brute
    pos = torch.cumsum(take, dim=1)
    slot = torch.where(take, pos - 1, n)  # n: a dropped column
    ids = torch.full((B, n + 1), n, dtype=torch.int32, device=unsafe.device)
    iota = torch.arange(n, dtype=torch.int32, device=unsafe.device)
    ids.scatter_(1, slot, iota.expand(B, n))
    count = pos[:, -1] if n else pos.new_zeros(B)
    return ids[:, :n].contiguous(), count.int()


def _patched(outs: tuple, patch: tuple, dest: torch.Tensor,
             count: torch.Tensor) -> tuple:
    """Each of ``outs`` ([N, ...]) with its rows ``dest`` [B, n] overwritten
    by ``patch`` ([B, n, ...], the same row order) up to each cloud's
    ``count``; the slots past it, and their rows, land in a dropped row."""
    N = outs[0].shape[0]
    j = torch.arange(dest.shape[1], device=dest.device)
    dest = torch.where(j[None, :] < count[:, None], dest.long(), N).reshape(-1)
    return tuple(
        torch.cat([o, o.new_zeros((1,) + o.shape[1:])]).index_copy_(
            0, dest, p.reshape((-1,) + o.shape[1:]).to(o.dtype))[:N]
        for o, p in zip(outs, patch))


def _apply_fallback(outs: tuple, unsafe: torch.Tensor, rows: torch.Tensor,
                    n_real: int, fallback_cap: int, brute) -> tuple:
    """Recompute the rows the grid could not prove exact, on the device:
    only those rows, or every row of ``rows`` once they outnumber the last
    fallback tier. ``brute(rows, row_ids [1, n], count [1])`` -> a tuple
    like ``outs`` with a leading row axis of n, in ``row_ids`` order, rows
    past the count unread. The count is recorded in ``UNSAFE_COUNTS``."""
    n_unsafe = unsafe.sum()
    _record_unsafe([n_unsafe])
    all_brute = n_unsafe > _fallback_caps(fallback_cap, n_real)[-1]
    row_ids, count = _patch_rows(unsafe[None], all_brute)
    patch = brute(rows, row_ids, count)
    return _patched(outs, tuple(p[None] for p in patch), row_ids, count)


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

    def brute(rows, row_ids, count):
        return (_brute_interp(rows, ref, values, k, eps, row_ids, count,
                              _patch_plan_rows(fallback_cap)),)
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


def _grid_interp_batched_layout(query, ref, values, k, grid_shape, tq,
                                slot_cap, fallback_cap, eps, xy_halo):
    """The flat-batched ``_grid_interp_single`` in layout order: query
    [B, Nq, 3], ref [B, M, 3], values [B, M, C] -> (v [NPg, C], qid [NPg]
    int32 global query ids b*Nq + i, B*Nq on padding), in one structure
    build, one kernel pass and one fallback ladder for every cloud.

    The ladder keeps each cloud's unsafe count on the device (in
    ``UNSAFE_COUNTS``, one entry a cloud) and picks the shared tier from
    the largest, as the TPU does: above the last tier every row of every
    cloud is brute-forced, else each cloud's unsafe rows. Either way one
    brute-force launch with a batch axis takes each cloud's rows, in query
    order through ``_patch_rows``, against its own cloud's refs, and
    ``_patched`` puts them at their layout positions (padding positions
    keep the grid's values)."""
    B, Nq, _ = query.shape
    Ng = B * Nq
    query, ref, values = query.float(), ref.float(), values.float()
    structb = _build_struct_batched(ref, grid_shape)
    v_out, safe, qid, q_pad = _query_pass(
        structb, query, k, grid_shape, tq, slot_cap, xy_halo=xy_halo,
        values=values, eps=eps, layout_out=True)
    NPg = v_out.shape[0]
    dev = query.device
    # each query's layout position (padding, qid == Ng, in a dropped slot)
    posq = qid.new_empty(Ng + 1).scatter_(
        0, qid, torch.arange(NPg, dtype=qid.dtype, device=dev))[:Ng]
    unsafe_q = ~safe[posq].reshape(B, Nq)  # in query order
    counts = unsafe_q.sum(1)
    _record_unsafe(counts.unbind(0))
    all_brute = counts.max() > _fallback_caps(fallback_cap, Nq)[-1]
    row_ids, count = _patch_rows(unsafe_q, all_brute)
    patch = _brute_interp_batched(query, ref, values, k, eps, row_ids, count,
                                  _patch_plan_rows(fallback_cap))
    # the slots past a cloud's count (their ids Nq) are dropped by _patched
    cloud = torch.arange(B, device=dev)[:, None] * Nq
    dest = posq[cloud + row_ids.clamp(max=Nq - 1)]
    (v_out,) = _patched((v_out,), (patch,), dest, count)
    return v_out, qid.int()


# Clouds a flat-batched pass takes at most: larger batches run in groups of
# this many, each one structure build, kernel pass and fallback ladder. The
# TPU's ceiling is its on-chip memory; here the same groups keep the
# reference's ladders (a group's tier follows its largest unsafe count) and
# bound the layout's working memory.
_BATCHED_MAX_GROUP = 8


def _batched_grid_ok(B: int, Nq: int, M: int, grid_shape, slot_cap: int,
                     k: int) -> bool:
    """Whether the flat-batched interpolation applies: B > 1, global query
    ids below 2^24, whole-column slots, and refs the grid engages."""
    return (B > 1 and B * Nq < 2 ** 24
            and _full_z_ok(M, tuple(grid_shape), slot_cap)
            and _grid_engages(M, k, grid_shape, slot_cap))


def grid_knn_interpolate_layout_batched(
        query: torch.Tensor, ref: torch.Tensor, values: torch.Tensor,
        k: int = 3, *, grid_shape=GRID_SHAPE, tq: int = 128,
        slot_cap: int = SLOT_CAP, fallback_cap: int = 4096, eps: float = 1e-8,
        xy_halo=1):
    """The flat-batched ``grid_knn_interpolate_layout``: query [B, Nq, 3],
    ref [B, M, 3], values [B, M, C] -> (v [NPg, C], qid [NPg] int32) with
    global query ids b*Nq + i and B*Nq on padding. Needs
    ``_batched_grid_ok``. Batches above ``_BATCHED_MAX_GROUP`` clouds run
    in groups (a trailing group of one through the one-cloud layout path),
    their ids lifted to the batch's."""
    if slot_cap % _LANE:
        raise ValueError(f"slot_cap must be a multiple of {_LANE}, got "
                         f"{slot_cap}")
    B, Nq, _ = query.shape
    if not _batched_grid_ok(B, Nq, ref.shape[1], grid_shape, slot_cap, k):
        raise ValueError(
            f"flat-batched grid interp requires B > 1, B*Nq < 2^24, a "
            f"full-column-z grid config and non-degenerate refs; got "
            f"B={B}, Nq={Nq}, M={ref.shape[1]}, grid_shape={grid_shape}, "
            f"slot_cap={slot_cap}")
    k = min(k, ref.shape[1])
    grid_shape = tuple(grid_shape)
    group = _BATCHED_MAX_GROUP
    args = (k, grid_shape, tq, slot_cap, fallback_cap)
    if B <= group:
        return _grid_interp_batched_layout(query, ref, values, *args, eps,
                                           xy_halo)
    vs, qids = [], []
    for s in range(0, B, group):
        e = min(s + group, B)
        if e - s == 1:
            v_g, qid_g = _grid_interp_single(query[s], ref[s], values[s],
                                             *args, 2, eps, xy_halo, True)
        else:
            v_g, qid_g = _grid_interp_batched_layout(
                query[s:e], ref[s:e], values[s:e], *args, eps, xy_halo)
        qids.append(torch.where(qid_g < (e - s) * Nq, qid_g + s * Nq,
                                B * Nq))
        vs.append(v_g)
    return torch.cat(vs), torch.cat(qids).int()


def _strip_interp_patch(struct: GridStruct, grid_shape, query: torch.Tensor,
                        ids: torch.Tensor, vals_pad: torch.Tensor, k: int,
                        eps: float, strip_blocks: int = 64, tp: int = 128):
    """Exact kNN + interpolation of chosen rows against their own +-1
    x-slab strip: the refs of slabs [lo, hi] are the contiguous run
    [SB[lo], SB[hi + 1]) of the slab-sorted refs, so a tile of ``tp`` rows
    (sorted by slab) takes one run through ``grid_interp``.

    ``ids`` [cap] (a multiple of ``tp``) are rows of ``query`` (``Nq`` on
    unused slots); ``vals_pad`` is ``_sorted_values``. Returns (ids_s [cap]
    int32, vals [cap, C], fail [cap]) in slab order; callers scatter by
    ``ids_s``. ``fail`` marks real rows the strip does not prove exact:
    the run overflows the TPU kernel's window of ``strip_blocks`` 128-ref
    blocks from its 128-aligned start (the kernel here scans the run whole,
    but the window decides, as ``tile_ok`` does in ``_layout_slots``), or
    the ball of the k-th distance reaches past the strip's x-interval
    (open at the domain's edges). A library facility: no entry point calls
    it."""
    if ids.shape[0] % tp:
        raise ValueError(f"cap={ids.shape[0]} must be a multiple of "
                         f"tp={tp}")
    Sx, Sy, Sz = grid_shape
    s = struct
    Nq = query.shape[0]
    cap = ids.shape[0]
    dev = query.device
    SB = torch.from_numpy(_partition_tables(s.M, Sx, Sy, Sz)[0]).to(dev)
    ids = ids.long()
    rows_ok = ids < Nq
    q_rows = query.float()[ids.clamp(0, Nq - 1)]
    qsx = torch.where(rows_ok, (q_rows[:, 0:1] >= s.xb[None, :]).sum(1), Sx)
    q_rows = torch.where(rows_ok[:, None], q_rows, _FAR)
    order = torch.sort(qsx, stable=True).indices  # unused slots sort last
    sx_s = qsx[order]
    ids_s = ids[order].clamp(max=Nq)
    q_pad = q_rows[order].contiguous()

    Tp = cap // tp
    sx_t = sx_s.reshape(Tp, tp)
    ok_t = (ids_s < Nq).reshape(Tp, tp)
    lo = (torch.where(ok_t, sx_t, Sx).amin(1) - 1).clamp(0, Sx - 1)
    hi = (torch.where(ok_t, sx_t, -1).amax(1) + 1).clamp(0, Sx - 1)
    st = SB[lo]
    en = torch.where(ok_t.any(1), SB[hi + 1], 0)
    bps = strip_blocks
    stb = (st // _LANE).clamp(0, max(s.M_pad // _LANE - bps, 0))
    tile_fit = (en - stb * _LANE) <= bps * _LANE  # [Tp]

    # a tile's real rows are a prefix of it: unused slots sort last
    v_s, d_s = grid_interp(q_pad, s.refs_pad, vals_pad,
                           st[:, None].int().contiguous(),
                           en[:, None].int().contiguous(), k, eps,
                           ok_t.sum(1, dtype=torch.int32))
    x_lo = s.xb_full[lo]  # [Tp]; +-inf at the domain's edges
    x_hi = s.xb_full[hi + 1]
    qx_t = q_pad[:, 0].reshape(Tp, tp)
    m = torch.minimum(qx_t - x_lo[:, None], x_hi[:, None] - qx_t)
    d_last = d_s[:, k - 1].reshape(Tp, tp)
    safe = tile_fit[:, None] & (d_last <= m * m) & (d_last < 1e29)
    fail = ~safe.reshape(-1) & (ids_s < Nq)
    return ids_s.int(), v_s, fail


def grid_knn_interpolate(query: torch.Tensor, ref: torch.Tensor,
                         values: torch.Tensor, k: int = 3, *,
                         grid_shape=GRID_SHAPE, tq: int = 128,
                         slot_cap: int = SLOT_CAP, fallback_cap: int = 4096,
                         z_halo: int = 2, eps: float = 1e-8,
                         xy_halo=1) -> torch.Tensor:
    """Exact kNN + inverse-distance interpolation: query [B, N, 3], ref
    [B, M, 3], values [B, M, C] -> [B, N, C] float32. A batch runs flat
    when ``_batched_grid_ok`` holds (in groups of ``_BATCHED_MAX_GROUP``
    clouds), else cloud after cloud."""
    _check_grid_args(slot_cap, query.shape[1], "grid_knn_interpolate")
    k = min(k, ref.shape[1])
    if not _grid_engages(ref.shape[1], k, grid_shape, slot_cap):
        return torch.stack([
            _brute_interp(q.float(), r.float(), v.float(), k, eps)
            for q, r, v in zip(query, ref, values)])
    B, Nq, _ = query.shape
    if _batched_grid_ok(B, Nq, ref.shape[1], grid_shape, slot_cap, k):
        kw = dict(grid_shape=grid_shape, tq=tq, slot_cap=slot_cap,
                  fallback_cap=fallback_cap, z_halo=z_halo, eps=eps,
                  xy_halo=xy_halo)
        group = _BATCHED_MAX_GROUP
        if B > group:
            return torch.cat([grid_knn_interpolate(
                query[s:s + group], ref[s:s + group], values[s:s + group], k,
                **kw) for s in range(0, B, group)])
        v_lay, qid = _grid_interp_batched_layout(
            query, ref, values, k, tuple(grid_shape), tq, slot_cap,
            fallback_cap, eps, xy_halo)
        # layout row j to query qid[j]; padding rows to a dropped row
        out = v_lay.new_empty((B * Nq + 1, v_lay.shape[1]))
        return out.index_copy_(0, qid.long(), v_lay)[:B * Nq].reshape(
            B, Nq, -1)
    return torch.stack([
        _grid_interp_single(q, r, v, k, tuple(grid_shape), tq, slot_cap,
                            fallback_cap, z_halo, eps, xy_halo, False)
        for q, r, v in zip(query, ref, values)])


def grid_knn_interpolate_layout(query: torch.Tensor, ref: torch.Tensor,
                                values: torch.Tensor, k: int = 3, *,
                                grid_shape=GRID_SHAPE, tq: int = 128,
                                slot_cap: int = SLOT_CAP,
                                fallback_cap: int = 4096,
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
    return _apply_fallback(
        (d_out, i_out), unsafe, query, query.shape[0], fallback_cap,
        lambda rows, row_ids, count: _brute(
            rows, ref, k, exact, row_ids, count,
            _patch_plan_rows(fallback_cap)))


def grid_knn(query: torch.Tensor, ref: torch.Tensor, k: int = 3, *,
             grid_shape=GRID_SHAPE, tq: int = 128,
             slot_cap: int = SLOT_CAP,
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
