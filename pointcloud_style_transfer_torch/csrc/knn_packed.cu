// Packed-key brute-force k nearest neighbours: the k smallest keys per query,
// where one 32-bit key holds a coarsened distance and the ref index.
//
// Replaces two TPU kernels of
// pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py:
//   * _topk_f32packed_kernel (wrappers _knn_f32packed_single,
//     pallas_knn_f32packed): key = ((bits(d) + 0x00800000) & ~0x7FFF) | index,
//     read as a float32 there; the running list starts at 1e30;
//   * _topk_packed_kernel (wrappers _knn_packed_single,
//     pallas_knn(exact=False)): key = ((bits(d) >>> 16) << idx_bits) | index,
//     an int32; the running list starts at 2^30.
// Keys are unique (the index is in the key), so the k smallest do not depend
// on any tiling or order of inserts. What is kept bit for bit:
//   * distances rounded op by op as (dx*dx + dy*dy) + dz*dz (the __f*_rn
//     intrinsics keep nvcc from contracting them into FMAs);
//   * the f32-packed keys are compared as unsigned integers, which orders
//     non-negative floats as their values do and needs no denormal handling;
//     a key is taken only below the current k-th key, so a distance that is
//     infinite or >= 2^127 (its biased key has the sign bit set) and any key
//     at or above the start value is never taken;
//   * the int-packed keys are compared as signed integers; an infinite
//     distance's key, (0x7F80 << idx_bits) | index, lies below the start
//     value and is taken while fewer than k other refs are left, as there;
//   * a NaN distance is refused explicitly in both (d != d), whatever its
//     sign bit: a set one would wrap the f32-packed key below every other;
//   * the TPU wrappers pad the refs to a multiple of their tile with points
//     at 1e15; here refs m..m_total-1 are those points, computed and not
//     stored (all lie at one place, so only the first k can matter).
// The wrapper decodes the index, recomputes the exact distance and sorts the
// k results, as the TPU wrappers do outside their kernels.
// The f32-packed kernel takes the count on the device as csrc/knn_topk.cu
// does (the kd-grid's inexact fallback, whose patch size is not known on the
// host): an int32 row-index array through which output row qi reads its
// query row, and a per-cloud int32 count of the output rows computed. The
// skip is decided per query block (blockIdx.x / S), the same for every rank
// of a cluster, so a cluster past the count exits before either barrier; a
// row at or past the count gets the start keys.
//
// What bounds it on the card: operations (2.7e9 pairs a sampler step against
// about 1.5 MB of inputs), 8 float ops a pair that may not be contracted
// into FMAs. A key costs 3 more integer ops, a NaN test and a compare with a
// branch on top of those 8, so neither kernel builds keys in its scan. One
// design serves both keys (scan_keys, as csrc/knn_topk.cu, with the key's
// own filter):
//   * one thread keeps its query's k keys sorted in registers; ref tiles
//     stream through shared memory as float4;
//   * the scan takes refs eight at a time and tries the inserts only when
//     the smallest of the eight distances' bits, taken as unsigned integers,
//     is below a bound derived from the current k-th key W. Unsigned bits
//     order non-negative floats as their values do, and a NaN of either
//     sign lies above every bound below 0x7FC00000. The bound is the
//     smallest bits whose key cannot be below W:
//       f32-packed: bits(d) + 0x00800000 < (W & ~0x7FFF) + 0x8000, i.e.
//         bound = (W & ~0x7FFF) + 0x8000 - 0x00800000 (every key is at least
//         0x00800000 and W at most the start key: a positive finite float's
//         bits, as PR 8's float threshold was);
//       int-packed: bits(d) >> 16 <= W >> idx_bits, i.e.
//         bound = ((W >> idx_bits) + 1) << 16, saturated at 0xFFFFFFFF. At
//         the start key 2^30 and idx_bits = 15 it is 0x80010000, which sets
//         the sign bit (so no float compare can stand in for it), and at
//         idx_bits <= 14 it passes 32 bits; an infinite distance's bits
//         0x7F800000 lie below it, as its key lies below 2^30.
//     The inserts behind the filter are the exact ones (the key, the NaN
//     refusal, the key's own '<'), and the bound is recomputed after each;
//   * the ref axis is split across a thread-block cluster of S blocks (the
//     caller's plan, as knn_topk's); rank r scans the r-th contiguous slice;
//     ranks 1..S-1 leave their keys in their shared memory and rank 0 inserts
//     them through distributed shared memory between two cluster barriers
//     (keys are unique, so no order rule is needed; a start key never passes
//     a strict '<'); rank 0 then offers the padding refs.
// Above k = 16 the keys leave the registers (scan_keys_global): each query's
// sorted list lives in the output buffer itself (global memory, hot in L1
// and L2) and only its k-th key and bound in registers, with the same scan,
// filter and exact inserts, and no cluster (S = 1). An insert shifts the
// keys above it up by one, which is what the register version's swap
// network does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile (16 KB)
constexpr int kUnroll = 8;   // refs tried together before any insert
constexpr int kMaxK = 16;    // keys in registers up to here
constexpr float kFar = 1e15f;  // the padding refs' coordinate

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The rows cloud b's launch computes: count[b] clipped to [0, nq], or nq.
__device__ __forceinline__ int row_count(const int* count, int b, int nq) {
  return count == nullptr ? nq : min(max(count[b], 0), nq);
}

// The query row (of the nsrc of its cloud) output row qi of cloud b reads:
// rows[b * nq + qi] clipped to [0, nsrc - 1], or qi itself.
__device__ __forceinline__ size_t query_row(const int* rows, int b, int nq,
                                            int nsrc, int qi) {
  if (rows == nullptr) return static_cast<size_t>(qi);
  const int r = rows[static_cast<size_t>(b) * nq + qi];
  return static_cast<size_t>(min(max(r, 0), nsrc - 1));
}

// The f32-packed key: unsigned, from 1e30's bits.
struct F32Key {
  using T = uint32_t;
  static constexpr T kStart = 0x7149F2CAu;  // bits of 1e30f
  static __device__ __forceinline__ T make(uint32_t bits, int col, int) {
    return ((bits + 0x00800000u) & ~0x7FFFu) | static_cast<uint32_t>(col);
  }
  // the distance bits at and above which no key is below w
  static __device__ __forceinline__ uint32_t bound(T w, int) {
    return (w & ~0x7FFFu) + 0x8000u - 0x00800000u;
  }
};

// The int-packed key: signed, from 2^30.
struct IntKey {
  using T = int;
  static constexpr T kStart = 1 << 30;
  static __device__ __forceinline__ T make(uint32_t bits, int col,
                                           int idx_bits) {
    return static_cast<int>(((bits >> 16) << idx_bits) |
                            static_cast<uint32_t>(col));
  }
  static __device__ __forceinline__ uint32_t bound(T w, int idx_bits) {
    const uint64_t b = (static_cast<uint64_t>(w >> idx_bits) + 1) << 16;
    return b > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(b);
  }
};

// Sorted insert of a key on the key's own strict '<' (a start key never
// passes).
template <class Key, int K>
__device__ __forceinline__ void insert_key(typename Key::T (&keys)[K],
                                           typename Key::T key) {
  using T = typename Key::T;
  if (key < keys[K - 1]) {
    keys[K - 1] = key;
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      if (keys[t] < keys[t - 1]) {
        const T tmp = keys[t];
        keys[t] = keys[t - 1];
        keys[t - 1] = tmp;
      }
    }
  }
}

// Offer ref col at distance d: its key, the NaN refusal, the key's '<';
// bound follows the k-th key.
template <class Key, int K>
__device__ __forceinline__ void offer(typename Key::T (&keys)[K],
                                      uint32_t& bound, float d, int col,
                                      int idx_bits) {
  if (d != d) return;  // NaN, whatever its sign bit
  const typename Key::T key = Key::make(__float_as_uint(d), col, idx_bits);
  if (key < keys[K - 1]) {
    insert_key<Key, K>(keys, key);
    bound = Key::bound(keys[K - 1], idx_bits);
  }
}

// The same on a list of k keys in global memory whose k-th is kth.
template <class Key>
__device__ __forceinline__ void offer_global(typename Key::T* keys, int k,
                                             typename Key::T& kth,
                                             uint32_t& bound, float d,
                                             int col, int idx_bits) {
  if (d != d) return;
  const typename Key::T key = Key::make(__float_as_uint(d), col, idx_bits);
  if (key < kth) {
    int t = k - 1;
    while (t > 0 && key < keys[t - 1]) {
      keys[t] = keys[t - 1];
      --t;
    }
    keys[t] = key;
    kth = keys[k - 1];
    bound = Key::bound(kth, idx_bits);
  }
}

// Stage refs [base, base + n) of this block's cloud as float4.
__device__ __forceinline__ void stage_tile(float4* smem,
                                           const float* __restrict__ ref,
                                           int base, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* p = ref + static_cast<size_t>(base + j) * 3;
    smem[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
  }
}

// Eight staged refs from j: their distances and the smallest of their bits
// as unsigned integers (a NaN of either sign is above every bound).
__device__ __forceinline__ uint32_t group_of_eight(const float4* smem, int j,
                                                   float qx, float qy,
                                                   float qz,
                                                   float (&d)[kUnroll]) {
#pragma unroll
  for (int v = 0; v < kUnroll; ++v) {
    const float4 r = smem[j + v];
    d[v] = sq_dist(qx, qy, qz, r.x, r.y, r.z);
  }
  uint32_t lowest = __float_as_uint(d[0]);
#pragma unroll
  for (int v = 1; v < kUnroll; ++v) lowest = min(lowest, __float_as_uint(d[v]));
  return lowest;
}

// grid (query blocks * S, batch), clusters of (S, 1, 1); thread t of the
// cluster of query block g serves output row qi = g * kThreads + t, which
// reads query row rows[b * nq + qi] (or qi without rows) of the nsrc rows of
// cloud b (padding rows past the count are scanned at the origin and get
// the start keys; a cluster wholly past it scans nothing).
template <class Key, int K>
__device__ __forceinline__ void scan_keys(const float* __restrict__ query,
                                          const float* __restrict__ ref,
                                          typename Key::T* __restrict__ k_out,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ count,
                                          int nq, int nsrc, int m, int m_total,
                                          int S, int idx_bits) {
  using T = typename Key::T;
  // a ref tile, then (S > 1) the rank's keys: key t of thread l at
  // [t * kThreads + l]
  static_assert(K * kThreads <= 4 * kTile, "keys > tile");
  __shared__ float4 smem[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nsrc * 3;
  ref += static_cast<size_t>(b) * m * 3;
  k_out += static_cast<size_t>(b) * nq * K;

  const int rank = blockIdx.x % S;  // the block's rank in its cluster
  const int block0 = static_cast<int>(blockIdx.x) / S * kThreads;  // 1st row
  const int qi = block0 + threadIdx.x;
  const int n_rows = row_count(count, b, nq);
  if (block0 >= n_rows) {  // the whole cluster: no row of it is computed
    if (rank == 0 && qi < nq) {
      for (int t = 0; t < K; ++t)
        k_out[static_cast<size_t>(qi) * K + t] = Key::kStart;
    }
    return;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < n_rows) {
    const size_t src = query_row(rows, b, nq, nsrc, qi);
    qx = query[src * 3 + 0];
    qy = query[src * 3 + 1];
    qz = query[src * 3 + 2];
  }
  T keys[K];
#pragma unroll
  for (int t = 0; t < K; ++t) keys[t] = Key::kStart;
  uint32_t bound = Key::bound(Key::kStart, idx_bits);

  // this rank's slice of the ref axis (empty when S exceeds m)
  const int chunk = (m + S - 1) / S;
  const int lo = min(m, rank * chunk);
  const int hi = min(m, lo + chunk);
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(smem, ref, base, n);
    __syncthreads();
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float d[kUnroll];
      if (group_of_eight(smem, j, qx, qy, qz, d) < bound) {
#pragma unroll
        for (int v = 0; v < kUnroll; ++v)
          if (__float_as_uint(d[v]) < bound)
            offer<Key, K>(keys, bound, d[v], base + j + v, idx_bits);
      }
    }
    for (; j < n; ++j) {
      const float4 r = smem[j];
      const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      if (__float_as_uint(d) < bound)
        offer<Key, K>(keys, bound, d, base + j, idx_bits);
    }
  }

  if (S > 1) {
    T* s_k = reinterpret_cast<T*>(smem);
    __syncthreads();  // the last tile is no longer read
    if (rank != 0) {
#pragma unroll
      for (int t = 0; t < K; ++t) s_k[t * kThreads + threadIdx.x] = keys[t];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // release the keys, acquire the other ranks'
    if (rank == 0) {
      for (int src = 1; src < S; ++src) {
        const T* rk = cluster.map_shared_rank(s_k, src);
#pragma unroll
        for (int t = 0; t < K; ++t)
          insert_key<Key, K>(keys, rk[t * kThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // no rank exits while its keys are read
    if (rank != 0) return;
  }

  if (qi >= nq) return;
  if (qi >= n_rows) {  // past the count: the start keys
#pragma unroll
    for (int t = 0; t < K; ++t)
      k_out[static_cast<size_t>(qi) * K + t] = Key::kStart;
    return;
  }
  // the padding refs: one place, ascending index, so k of them suffice
  const int n_pad = min(K, m_total - m);
  const float d_pad = sq_dist(qx, qy, qz, kFar, kFar, kFar);
  for (int t = 0; t < n_pad; ++t)
    offer<Key, K>(keys, bound, d_pad, m + t, idx_bits);
#pragma unroll
  for (int t = 0; t < K; ++t) k_out[static_cast<size_t>(qi) * K + t] = keys[t];
}

// grid (query blocks, batch), no cluster; any k >= 1. Thread t of query
// block g serves output row qi = g * kThreads + t, its list at k_out [qi, :];
// rows and count as in scan_keys.
template <class Key>
__device__ __forceinline__ void scan_keys_global(
    const float* __restrict__ query, const float* __restrict__ ref,
    typename Key::T* __restrict__ k_out, const int* __restrict__ rows,
    const int* __restrict__ count, int nq, int nsrc, int m, int m_total,
    int k, int idx_bits) {
  using T = typename Key::T;
  __shared__ float4 smem[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nsrc * 3;
  ref += static_cast<size_t>(b) * m * 3;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  T* keys = k_out + (static_cast<size_t>(b) * nq + qi) * k;
  if (qi < nq) {
    for (int t = 0; t < k; ++t) keys[t] = Key::kStart;
  }
  const int n_rows = row_count(count, b, nq);
  if (static_cast<int>(blockIdx.x) * kThreads >= n_rows) return;  // no scan
  const bool active = qi < n_rows;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const size_t src = query_row(rows, b, nq, nsrc, qi);
    qx = query[src * 3 + 0];
    qy = query[src * 3 + 1];
    qz = query[src * 3 + 2];
  }
  T kth = Key::kStart;
  uint32_t bound = Key::bound(kth, idx_bits);

  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(smem, ref, base, n);
    __syncthreads();
    if (!active) continue;
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float d[kUnroll];
      if (group_of_eight(smem, j, qx, qy, qz, d) < bound) {
#pragma unroll
        for (int v = 0; v < kUnroll; ++v)
          if (__float_as_uint(d[v]) < bound)
            offer_global<Key>(keys, k, kth, bound, d[v], base + j + v,
                              idx_bits);
      }
    }
    for (; j < n; ++j) {
      const float4 r = smem[j];
      const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      if (__float_as_uint(d) < bound)
        offer_global<Key>(keys, k, kth, bound, d, base + j, idx_bits);
    }
  }
  if (!active) return;
  const int n_pad = min(k, m_total - m);
  const float d_pad = sq_dist(qx, qy, qz, kFar, kFar, kFar);
  for (int t = 0; t < n_pad; ++t)
    offer_global<Key>(keys, k, kth, bound, d_pad, m + t, idx_bits);
}

// The four kernels, named for the profiler and ptxas. (One block per SM at
// least, as knn_topk_kernel: more registers.)
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_f32packed_kernel(const float* __restrict__ query,
                     const float* __restrict__ ref,
                     uint32_t* __restrict__ k_out,
                     const int* __restrict__ rows,
                     const int* __restrict__ count, int nq, int nsrc, int m,
                     int m_total, int S) {
  scan_keys<F32Key, K>(query, ref, k_out, rows, count, nq, nsrc, m, m_total,
                       S, 0);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_packed_kernel(const float* __restrict__ query,
                  const float* __restrict__ ref, int* __restrict__ k_out,
                  int nq, int m, int m_total, int S, int idx_bits) {
  scan_keys<IntKey, K>(query, ref, k_out, nullptr, nullptr, nq, nq, m,
                       m_total, S, idx_bits);
}

__global__ void __launch_bounds__(kThreads)
knn_f32packed_global_kernel(const float* __restrict__ query,
                            const float* __restrict__ ref,
                            uint32_t* __restrict__ k_out,
                            const int* __restrict__ rows,
                            const int* __restrict__ count, int nq, int nsrc,
                            int m, int m_total, int k) {
  scan_keys_global<F32Key>(query, ref, k_out, rows, count, nq, nsrc, m,
                           m_total, k, 0);
}

__global__ void __launch_bounds__(kThreads)
knn_packed_global_kernel(const float* __restrict__ query,
                         const float* __restrict__ ref,
                         int* __restrict__ k_out, int nq, int m, int m_total,
                         int k, int idx_bits) {
  scan_keys_global<IntKey>(query, ref, k_out, nullptr, nullptr, nq, nq, m,
                           m_total, k, idx_bits);
}

// A launch of grid (query blocks * S, batch) in clusters of S.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int batch, int nq, int S,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((nq + kThreads - 1) / kThreads) * S, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

bool bad_plan(int k, int S) {
  return k < 1 || (S != 1 && S != 2 && S != 4 && S != 8) ||
         (k > kMaxK && S != 1);
}

cudaError_t finish(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return err != cudaSuccess ? err : last;
}

}  // namespace

#define PCST_KS(X)                                                        \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

// query [batch, nsrc, 3] f32, ref [batch, m, 3] f32 -> keys_out
// [batch, nq, k] (the bits of the f32-packed keys, ascending), all
// contiguous. rows (nullable): [batch, nq] i32, the query row each output row
// reads (else row qi reads query row qi, and nsrc must be nq); count
// (nullable): [batch] i32 on the device, the output rows of each cloud that
// are computed (the rest get the start keys). m <= m_total <= 2^15: refs
// m..m_total-1 are padding points at 1e15. k >= 1; S in {1, 2, 4, 8} ranks
// per cluster for k <= 16, S = 1 above. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pcst_knn_f32packed(const void* query, const void* ref,
                                  void* keys_out, const void* rows,
                                  const void* count, int batch, int nq,
                                  int nsrc, int m, int m_total, int k, int S,
                                  void* stream) {
  if (m_total < m || m_total > (1 << 15) || bad_plan(k, S) || nsrc < 1 ||
      (rows == nullptr && nsrc != nq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  uint32_t* o = static_cast<uint32_t*>(keys_out);
  const int* rw = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    return static_cast<int>(finish(launch(knn_f32packed_global_kernel, batch,
                                          nq, 1, s, q, r, o, rw, c, nq, nsrc,
                                          m, m_total, k)));
  }
  cudaError_t err = cudaSuccess;
  switch (k) {
#define PCST_K(KK)                                                          \
  case KK:                                                                  \
    err = launch(knn_f32packed_kernel<KK>, batch, nq, S, s, q, r, o, rw, c,  \
                 nq, nsrc, m, m_total, S);                                  \
    break;
    PCST_KS(PCST_K)
#undef PCST_K
  }
  return static_cast<int>(finish(err));
}

// The int32 keys ((bits(d) >>> 16) << idx_bits) | index, ascending;
// 1 <= idx_bits <= 15 and m <= m_total <= 2^idx_bits; k and S as above.
extern "C" int pcst_knn_packed(const void* query, const void* ref,
                               void* keys_out, int batch, int nq, int m,
                               int m_total, int idx_bits, int k, int S,
                               void* stream) {
  if (m_total < m || idx_bits < 1 || idx_bits > 15 ||
      m_total > (1 << idx_bits) || bad_plan(k, S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  int* o = static_cast<int*>(keys_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    return static_cast<int>(finish(launch(knn_packed_global_kernel, batch, nq,
                                          1, s, q, r, o, nq, m, m_total, k,
                                          idx_bits)));
  }
  cudaError_t err = cudaSuccess;
  switch (k) {
#define PCST_K(KK)                                                       \
  case KK:                                                               \
    err = launch(knn_packed_kernel<KK>, batch, nq, S, s, q, r, o, nq, m, \
                 m_total, S, idx_bits);                                  \
    break;
    PCST_KS(PCST_K)
#undef PCST_K
  }
  return static_cast<int>(finish(err));
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
