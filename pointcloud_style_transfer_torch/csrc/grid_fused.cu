// Slot-run kNN of the equal-count kd-grid: top-k over the candidate runs of
// each query tile, with or without the fused inverse-distance interpolation.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/grid_fused.py::
// _grid_interp_kernel (wrapper grid_interp_resident; entry pcst_grid_interp)
// and ::_grid_topk_kernel (wrapper grid_topk_resident; entry pcst_grid_topk).
// Semantics kept:
//   * tile t (queries [t*tq, (t+1)*tq) of the tile-padded layout) sees exactly
//     the refs at sorted positions in the union of its slot runs
//     [st[t,s], en[t,s]); the runs of one tile are disjoint by construction;
//   * distances in squared-difference form, rounded op by op as
//     (dx*dx + dy*dy) + dz*dz (the __f*_rn intrinsics stop nvcc from
//     contracting them into FMAs, so the plain PyTorch version reproduces
//     every bit);
//   * a running sorted top-k that starts at (1e30, position 0) and takes a
//     candidate only when (d, position) is lexicographically smaller than
//     its last entry, so ties resolve to the lowest sorted position whatever
//     order the candidates come in; a NaN distance is never taken;
//   * rows at or past n_real[t] (the layout's padding, a suffix of each
//     tile) keep the start list (1e30, 0); without n_real every row is real;
//   * interpolation: w_u = 1/(sqrt(max(d_u, 0)) + eps), wsum = (w_0 + w_1)
//     + ..., v_c = sum_u (w_u / wsum) * vals[pos_u, c], summed in u order;
//   * top-k positions clipped to [0, m_pad - 1].
//
// What bounds it on the card: operations. At the sampler's shapes (896
// tiles of 128 queries, three y-run slots, about 1,230 candidates a tile)
// the real queries need 1.14e8 pairs of 8 float ops that may not be fused
// into FMAs: 0.027 ms at the card's FP32 issue rate, against about 3 MB of
// inputs and outputs. The scan issues about 10 instructions a pair (the 8
// float ops, three LDS.128 per four refs, a minimum and a compare per
// eight), and a warp runs an insert whenever any of its 32 queries takes a
// ref; PERF.md (PR 6) has the kernel's time against the bound. Design, one
// block per tile, one thread per query, its top-k in registers (unrolled
// insert, no local memory):
//   * the layout's padding is not scanned: a tile with no real row skips
//     straight to its epilogue, and so does every warp whose 32 rows are
//     all padding (the real rows of a tile are a prefix of it);
//   * the block stages the tile's runs through shared memory in chunks of
//     kChunk refs, one pair of barriers per chunk, with coalesced loads, as
//     four arrays x, y, z and sorted position; a thread reads four refs' x
//     (y, z) in one LDS.128, 12 bytes a pair;
//   * the staging order starts with the middle third of the middle slot
//     (the tile's own row of its own slab on the grid's tables), so each
//     query's k-th distance is tight early and inserts stay rare; any order
//     gives the same result, since the insert compares (distance, sorted
//     position) and positions travel with the refs;
//   * the scan takes eight refs at a time, takes the minimum of their
//     distances and tries the inserts only when it is <= the k-th distance
//     (<=: an equal distance may still win on its position), as
//     csrc/knn_topk.cu does.
// The TPU kernel's 128-aligned windows, scalar prefetch and VMEM-resident
// ref array have no counterpart: the block reads its own slot row and scans
// [st, en) exactly. The values are not staged: the epilogue reads the k
// selected rows of vals from global memory (30k x 3 floats stay in L2).
// Above k = 16 the lists leave the registers (GlobalList): each row's
// sorted list lives in the output (d_out, and i_out or, for the
// interpolation, a scratch of positions), its k-th entry in registers, with
// the same staging, filter and tie order; the epilogue computes each weight
// again where it needs it (the same bits every time). The interpolation
// takes that kernel also for k = 9..16 on tiles wider than 512 rows, where
// its register lists would spill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;  // tq: one thread per query of a tile
constexpr int kWideThreads = 512;  // tq of the interpolation's k = 9..16
constexpr int kUnroll = 8;         // refs tried together before any insert
// refs staged at a time, a multiple of 8, 16 bytes each (24 KB): a whole
// tile of the sampler's tables (at most ~1,400 candidates). On an H100 at
// those tables 256 to 2,048 time within 8% of each other, 3,072 ~25%
// slower (fewer blocks fit an SM); tools/sweep_kernel_plans.py rebuilds
// with -DPCST_GRID_CHUNK=n
#ifndef PCST_GRID_CHUNK
#define PCST_GRID_CHUNK 1536
#endif
constexpr int kChunk = PCST_GRID_CHUNK;
static_assert(kChunk % 8 == 0 && kChunk * 16 <= 48 * 1024,
              "the chunk is a multiple of 8 in static shared memory");
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (d, p) before (e, q): lexicographic on (distance, sorted position); a NaN
// d is never before anything
__device__ __forceinline__ bool before(float d, int p, float e, int q) {
  return d < e || (d == e && p < q);
}

// A row's running top-k in registers, ascending by (distance, position).
template <int K>
struct RegList {
  float D[K];
  int I[K];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      D[u] = kBig;
      I[u] = 0;
    }
  }
  __device__ __forceinline__ float kth() const { return D[K - 1]; }
  __device__ __forceinline__ void insert(float d, int p) {
    if (before(d, p, D[K - 1], I[K - 1])) {
      D[K - 1] = d;
      I[K - 1] = p;
#pragma unroll
      for (int t = K - 1; t > 0; --t) {
        if (before(D[t], I[t], D[t - 1], I[t - 1])) {
          const float td = D[t];
          D[t] = D[t - 1];
          D[t - 1] = td;
          const int ti = I[t];
          I[t] = I[t - 1];
          I[t - 1] = ti;
        }
      }
    }
  }
};

// The same list of k entries in global memory (D[0..k-1], I[0..k-1]), its
// k-th entry in registers; an insert shifts the entries after it by one.
struct GlobalList {
  float* D;
  int* I;
  int k;
  float kd = kBig;
  int kp = 0;
  __device__ __forceinline__ void reset() {
    for (int u = 0; u < k; ++u) {
      D[u] = kBig;
      I[u] = 0;
    }
    kd = kBig;
    kp = 0;
  }
  __device__ __forceinline__ float kth() const { return kd; }
  __device__ __forceinline__ void insert(float d, int p) {
    if (before(d, p, kd, kp)) {
      int t = k - 1;
      while (t > 0 && before(d, p, D[t - 1], I[t - 1])) {
        D[t] = D[t - 1];
        I[t] = I[t - 1];
        --t;
      }
      D[t] = d;
      I[t] = p;
      kd = D[k - 1];
      kp = I[k - 1];
    }
  }
};

// The staged chunk: refs as x[], y[], z[] and position p[] (each array
// 16-byte aligned, for the LDS.128 reads).
struct Stage {
  alignas(16) float x[kChunk];
  alignas(16) float y[kChunk];
  alignas(16) float z[kChunk];
  alignas(16) int p[kChunk];
};

// One staged chunk of n refs against this thread's query.
template <class List>
__device__ __forceinline__ void scan_chunk(const Stage& st, int n, float qx,
                                           float qy, float qz, List& list) {
  int j = 0;
  for (; j + kUnroll <= n; j += kUnroll) {
    float d[kUnroll];
#pragma unroll
    for (int h = 0; h < kUnroll; h += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(st.x + j + h);
      const float4 y4 = *reinterpret_cast<const float4*>(st.y + j + h);
      const float4 z4 = *reinterpret_cast<const float4*>(st.z + j + h);
      d[h] = sq_dist(qx, qy, qz, x4.x, y4.x, z4.x);
      d[h + 1] = sq_dist(qx, qy, qz, x4.y, y4.y, z4.y);
      d[h + 2] = sq_dist(qx, qy, qz, x4.z, y4.z, z4.z);
      d[h + 3] = sq_dist(qx, qy, qz, x4.w, y4.w, z4.w);
    }
    // fminf drops a NaN; the inserts below refuse it on their own
    const float lowest =
        fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
              fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
    if (lowest <= list.kth()) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) list.insert(d[u], st.p[j + u]);
    }
  }
  for (; j < n; ++j)
    list.insert(sq_dist(qx, qy, qz, st.x[j], st.y[j], st.z[j]), st.p[j]);
}

// Piece i of the tile's staging order, [lo, lo + len) of the sorted refs:
// the middle third of the middle slot's run, its first third, its last
// third, then the other slots' runs in slot order (runs clipped to
// [0, m_pad)). Together the pieces are the tile's runs, each ref once.
__device__ __forceinline__ void piece(const int* st_row, const int* en_row,
                                      int n_slots, int m_pad, int i, int& lo,
                                      int& len) {
  const int m = n_slots / 2;
  if (i >= 3) {
    const int s = i - 3 < m ? i - 3 : i - 2;
    lo = max(__ldg(st_row + s), 0);
    len = max(min(__ldg(en_row + s), m_pad) - lo, 0);
    return;
  }
  const int mlo = max(__ldg(st_row + m), 0);
  const int mlen = max(min(__ldg(en_row + m), m_pad) - mlo, 0);
  const int a = mlen / 3, b = 2 * mlen / 3;
  lo = mlo + (i == 0 ? a : i == 1 ? 0 : b);
  len = i == 0 ? b - a : i == 1 ? a : mlen - b;
}

// The top-k of the tile's candidates for this thread's query, ascending;
// the start list on a padding row.
template <class List>
__device__ __forceinline__ void scan_tile(
    const float* __restrict__ q_pad, const float* __restrict__ refs,
    const int* __restrict__ st_tab, const int* __restrict__ en_tab,
    const int* __restrict__ n_real_tab, int n_slots, int m_pad, Stage& stage,
    List& list) {
  list.reset();
  const int tile = blockIdx.x;
  const int row = threadIdx.x;
  const int tq = blockDim.x;
  const int n_real = n_real_tab == nullptr
                         ? tq
                         : min(max(__ldg(n_real_tab + tile), 0), tq);
  if (n_real == 0 || n_slots == 0) return;  // the whole block, no barrier
  const bool scans = (row & ~31) < n_real;  // its warp holds a real row
  const size_t qi = static_cast<size_t>(tile) * tq + row;
  const float qx = q_pad[qi * 3 + 0];
  const float qy = q_pad[qi * 3 + 1];
  const float qz = q_pad[qi * 3 + 2];

  const int* st_row = st_tab + static_cast<size_t>(tile) * n_slots;
  const int* en_row = en_tab + static_cast<size_t>(tile) * n_slots;
  const int n_pieces = n_slots + 2;
  int total = 0;
  for (int i = 0; i < n_pieces; ++i) {
    int lo, len;
    piece(st_row, en_row, n_slots, m_pad, i, lo, len);
    total += len;
  }
  for (int c0 = 0; c0 < total; c0 += kChunk) {
    const int n = min(kChunk, total - c0);
    __syncthreads();  // the previous chunk is no longer read
    // candidates [c0, c0 + n) of the staging order: piece i holds
    // [pre, pre + len) of it, candidate c sorted position lo + c - pre
    int pre = 0;
    for (int i = 0; i < n_pieces && pre < c0 + n; ++i) {
      int lo, len;
      piece(st_row, en_row, n_slots, m_pad, i, lo, len);
      const int a = max(pre, c0);
      const int b = min(pre + len, c0 + n);
      for (int c = a + row; c < b; c += tq) {
        const int p = lo + (c - pre);
        const float* r = refs + static_cast<size_t>(p) * 3;
        stage.x[c - c0] = __ldg(r);
        stage.y[c - c0] = __ldg(r + 1);
        stage.z[c - c0] = __ldg(r + 2);
        stage.p[c - c0] = p;
      }
      pre += len;
    }
    __syncthreads();
    if (scans) scan_chunk(stage, n, qx, qy, qz, list);
  }
  if (row >= n_real) list.reset();  // a padding row of a scanning warp
}

// The interpolation weight of a distance: 1 / (sqrt(max(d, 0)) + eps).
__device__ __forceinline__ float weight(float d, float eps) {
  return __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(d, 0.f)), eps));
}

// v[c] = sum_u (w_u / wsum) * vals[I[u], c] for a row's k entries, each
// weight computed where it is needed (the same bits each time), so that no
// array of weights is held.
__device__ __forceinline__ void interp_values(const float* D, const int* I,
                                              int k,
                                              const float* __restrict__ vals,
                                              int n_chan, float eps,
                                              float* __restrict__ v) {
  float wsum = weight(D[0], eps);
  for (int u = 1; u < k; ++u) wsum = __fadd_rn(wsum, weight(D[u], eps));
  for (int c = 0; c < n_chan; ++c) {
    float acc = __fmul_rn(__fdiv_rn(weight(D[0], eps), wsum),
                          __ldg(vals + static_cast<size_t>(I[0]) * n_chan + c));
    for (int u = 1; u < k; ++u) {
      acc = __fadd_rn(acc, __fmul_rn(__fdiv_rn(weight(D[u], eps), wsum),
                                     __ldg(vals + static_cast<size_t>(I[u]) *
                                                      n_chan + c)));
    }
    v[c] = acc;
  }
}

// grid (n_tiles), block tq threads: thread t serves row t of its tile.
// (The minimum of one block per SM lets ptxas give the lists the registers
// they need: without it grid_topk_kernel<3> stopped at 32 and spilled.
// 1,024 threads leave 64 registers a thread, where the interpolation's
// lists and weights spill from k = 14; above k = 8 it takes at most
// kWideThreads a block and 128 registers, and wider tiles its global-list
// kernel.)
template <int K>
__global__ void __launch_bounds__(K > 8 ? kWideThreads : kMaxThreads, 1)
grid_interp_kernel(const float* __restrict__ q_pad,
                   const float* __restrict__ refs,
                   const float* __restrict__ vals,
                   const int* __restrict__ st_tab,
                   const int* __restrict__ en_tab,
                   const int* __restrict__ n_real,
                   float* __restrict__ v_out, float* __restrict__ d_out,
                   int n_slots, int m_pad, int n_chan, float eps) {
  __shared__ Stage stage;
  RegList<K> list;
  scan_tile(q_pad, refs, st_tab, en_tab, n_real, n_slots, m_pad, stage, list);
  const float(&D)[K] = list.D;
  const int(&I)[K] = list.I;

  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float w[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    w[u] = weight(D[u], eps);
    d_out[qi * K + u] = D[u];
  }
  float wsum = w[0];
#pragma unroll
  for (int u = 1; u < K; ++u) wsum = __fadd_rn(wsum, w[u]);
#pragma unroll
  for (int u = 0; u < K; ++u) w[u] = __fdiv_rn(w[u], wsum);
  for (int c = 0; c < n_chan; ++c) {
    float acc = __fmul_rn(w[0], __ldg(vals + static_cast<size_t>(I[0]) * n_chan + c));
#pragma unroll
    for (int u = 1; u < K; ++u) {
      acc = __fadd_rn(
          acc, __fmul_rn(w[u], __ldg(vals + static_cast<size_t>(I[u]) * n_chan + c)));
    }
    v_out[qi * n_chan + c] = acc;
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
grid_topk_kernel(const float* __restrict__ q_pad,
                 const float* __restrict__ refs,
                 const int* __restrict__ st_tab,
                 const int* __restrict__ en_tab,
                 const int* __restrict__ n_real, float* __restrict__ d_out,
                 int* __restrict__ i_out, int n_slots, int m_pad) {
  __shared__ Stage stage;
  RegList<K> list;
  scan_tile(q_pad, refs, st_tab, en_tab, n_real, n_slots, m_pad, stage, list);

  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    d_out[qi * K + u] = list.D[u];
    i_out[qi * K + u] = min(max(list.I[u], 0), m_pad - 1);
  }
}

// k > 16: the lists in d_out and i_pos [n_tiles*tq, k] (the interpolation's
// positions are a scratch); the same grid and block.
__global__ void __launch_bounds__(kMaxThreads, 1)
grid_interp_global_kernel(const float* __restrict__ q_pad,
                          const float* __restrict__ refs,
                          const float* __restrict__ vals,
                          const int* __restrict__ st_tab,
                          const int* __restrict__ en_tab,
                          const int* __restrict__ n_real,
                          float* __restrict__ v_out, float* __restrict__ d_out,
                          int* __restrict__ i_pos, int n_slots, int m_pad,
                          int n_chan, int k, float eps) {
  __shared__ Stage stage;
  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  GlobalList list{d_out + qi * k, i_pos + qi * k, k};
  scan_tile(q_pad, refs, st_tab, en_tab, n_real, n_slots, m_pad, stage, list);
  interp_values(list.D, list.I, k, vals, n_chan, eps, v_out + qi * n_chan);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
grid_topk_global_kernel(const float* __restrict__ q_pad,
                        const float* __restrict__ refs,
                        const int* __restrict__ st_tab,
                        const int* __restrict__ en_tab,
                        const int* __restrict__ n_real,
                        float* __restrict__ d_out, int* __restrict__ i_out,
                        int n_slots, int m_pad, int k) {
  __shared__ Stage stage;
  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  GlobalList list{d_out + qi * k, i_out + qi * k, k};
  scan_tile(q_pad, refs, st_tab, en_tab, n_real, n_slots, m_pad, stage, list);
  for (int u = 0; u < k; ++u) list.I[u] = min(max(list.I[u], 0), m_pad - 1);
}

bool bad_shape(int n_tiles, int tq, int n_slots, int m_pad, int k) {
  return n_tiles < 1 || tq < 1 || tq > kMaxThreads || n_slots < 0 ||
         m_pad < 1 || k < 1;
}

constexpr int kMaxK = 16;  // lists in registers up to here

}  // namespace

#define PCST_KS(X)                                                        \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

// q_pad [n_tiles*tq, 3] f32, refs [m_pad, 3] f32, vals [m_pad, n_chan] f32,
// st/en [n_tiles, n_slots] i32, n_real [n_tiles] i32 or null (every row
// real) -> v_out [n_tiles*tq, n_chan] f32, d_out [n_tiles*tq, k] f32, all
// contiguous; the global-list kernel (k > 16, or k > 8 with tq > 512) also
// takes i_scratch [n_tiles*tq, k] i32 (may be null otherwise). k >= 1,
// 1 <= tq <= 1024. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pcst_grid_interp(const void* q_pad, const void* refs,
                                const void* vals, const void* st,
                                const void* en, const void* n_real,
                                void* v_out, void* d_out, void* i_scratch,
                                int n_tiles, int tq, int n_slots, int m_pad,
                                int n_chan, int k, float eps, void* stream) {
  const bool global = k > kMaxK || (k > 8 && tq > kWideThreads);
  if (bad_shape(n_tiles, tq, n_slots, m_pad, k) || n_chan < 1 ||
      (global && i_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(q_pad);
  const float* r = static_cast<const float*>(refs);
  const float* v = static_cast<const float*>(vals);
  const int* s = static_cast<const int*>(st);
  const int* e = static_cast<const int*>(en);
  const int* nr = static_cast<const int*>(n_real);
  float* vo = static_cast<float*>(v_out);
  float* d = static_cast<float*>(d_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (global ? 0 : k) {
#define PCST_INTERP(K)                                                     \
  case K:                                                                  \
    grid_interp_kernel<K><<<n_tiles, tq, 0, cs>>>(q, r, v, s, e, nr, vo, d, \
                                                  n_slots, m_pad, n_chan,  \
                                                  eps);                    \
    break;
    PCST_KS(PCST_INTERP)
#undef PCST_INTERP
    default:
      grid_interp_global_kernel<<<n_tiles, tq, 0, cs>>>(
          q, r, v, s, e, nr, vo, d, static_cast<int*>(i_scratch), n_slots,
          m_pad, n_chan, k, eps);
  }
  // also clears a launch error
  return static_cast<int>(cudaGetLastError());
}

// q_pad [n_tiles*tq, 3] f32, refs [m_pad, 3] f32, st/en [n_tiles, n_slots]
// i32, n_real [n_tiles] i32 or null -> d_out [n_tiles*tq, k] f32, i_out
// [n_tiles*tq, k] i32 (sorted positions), all contiguous. k >= 1,
// 1 <= tq <= 1024. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pcst_grid_topk(const void* q_pad, const void* refs,
                              const void* st, const void* en,
                              const void* n_real, void* d_out, void* i_out,
                              int n_tiles, int tq, int n_slots, int m_pad,
                              int k, void* stream) {
  if (bad_shape(n_tiles, tq, n_slots, m_pad, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(q_pad);
  const float* r = static_cast<const float*>(refs);
  const int* s = static_cast<const int*>(st);
  const int* e = static_cast<const int*>(en);
  const int* nr = static_cast<const int*>(n_real);
  float* d = static_cast<float*>(d_out);
  int* i = static_cast<int*>(i_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCST_TOPK(K)                                                       \
  case K:                                                                  \
    grid_topk_kernel<K><<<n_tiles, tq, 0, cs>>>(q, r, s, e, nr, d, i,      \
                                                n_slots, m_pad);           \
    break;
    PCST_KS(PCST_TOPK)
#undef PCST_TOPK
    default:
      grid_topk_global_kernel<<<n_tiles, tq, 0, cs>>>(q, r, s, e, nr, d, i,
                                                      n_slots, m_pad, k);
  }
  // also clears a launch error
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
