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
//   * the int-packed keys are compared as signed integers;
//   * a NaN distance is refused explicitly in both (d != d), whatever its
//     sign bit: a set one would wrap the f32-packed key below every other;
//   * the TPU wrappers pad the refs to a multiple of their tile with points
//     at 1e15; here refs m..m_total-1 are those points, computed and not
//     stored (all lie at one place, so only the first k can matter).
// The wrapper decodes the index, recomputes the exact distance and sorts the
// k results, as the TPU wrappers do outside their kernels.
//
// What bounds it on the card: operations (2.7e9 pairs a sampler step against
// about 1.5 MB of inputs), 8 float ops a pair that may not be contracted
// into FMAs. A key costs 3 more integer ops, a NaN test and an unsigned
// compare with a branch on top of those 8, so the f32-packed kernel does
// not build keys in its scan. Design of knn_f32packed_kernel (as
// csrc/knn_topk.cu, with the key's own filter):
//   * one thread keeps its query's k keys sorted in registers; ref tiles
//     stream through shared memory as float4;
//   * the scan takes refs eight at a time and tries the inserts only when
//     the smallest of the eight float distances (fminf drops a NaN) is below
//     a float threshold derived from the current k-th key W:
//       thr = float((W & ~0x7FFF) + 0x8000 - 0x00800000).
//     A key is below W only if its coarse part is at most W's, i.e. only if
//     bits(d) + 0x00800000 < (W & ~0x7FFF) + 0x8000, which for a
//     non-negative d is d < thr. Every key is at least 0x00800000 and W at
//     most the start key, so thr is a positive finite float. The inserts
//     behind the filter are the exact ones (the key, the NaN refusal, the
//     unsigned '<'), and thr is recomputed after each;
//   * the ref axis is split across a thread-block cluster of S blocks (the
//     caller's plan, as knn_topk's); rank r scans the r-th contiguous slice;
//     ranks 1..S-1 leave their keys in their shared memory and rank 0 inserts
//     them through distributed shared memory between two cluster barriers
//     (keys are unique, so no order rule is needed; a start key never passes
//     a strict '<'); rank 0 then offers the padding refs.
// The int-packed kernel (knn_packed_kernel) is the first design: one thread
// a query over the whole ref axis, a key built and compared for every pair.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile (16 KB)
constexpr int kUnroll = 8;   // refs tried together before any insert
constexpr float kFar = 1e15f;  // the padding refs' coordinate
constexpr uint32_t kStartF32 = 0x7149F2CAu;  // bits of 1e30f
constexpr int kStartInt = 1 << 30;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---- f32-packed keys ----

// The distance below which a key can be below w (see the note above).
__device__ __forceinline__ float key_bound(uint32_t w) {
  return __uint_as_float((w & ~0x7FFFu) + 0x8000u - 0x00800000u);
}

// Sorted insert of a key on unsigned '<' (a start key never passes).
template <int K>
__device__ __forceinline__ void insert_key(uint32_t (&keys)[K], uint32_t key) {
  if (key < keys[K - 1]) {
    keys[K - 1] = key;
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      if (keys[t] < keys[t - 1]) {
        const uint32_t tmp = keys[t];
        keys[t] = keys[t - 1];
        keys[t - 1] = tmp;
      }
    }
  }
}

// Offer ref col at distance d: its key, the NaN refusal, the unsigned '<';
// bound follows the k-th key.
template <int K>
__device__ __forceinline__ void offer(uint32_t (&keys)[K], float& bound,
                                      float d, int col) {
  if (d != d) return;  // NaN, whatever its sign bit
  const uint32_t key = ((__float_as_uint(d) + 0x00800000u) & ~0x7FFFu) |
                       static_cast<uint32_t>(col);
  if (key < keys[K - 1]) {
    insert_key<K>(keys, key);
    bound = key_bound(keys[K - 1]);
  }
}

// grid (query blocks * S, batch), clusters of (S, 1, 1); thread t of the
// cluster of query block g serves query g * kThreads + t (padding queries
// past nq are scanned at the origin, never written). (One block per SM at
// least, as knn_topk_kernel: more registers.)
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_f32packed_kernel(const float* __restrict__ query,
                     const float* __restrict__ ref,
                     uint32_t* __restrict__ k_out, int nq, int m,
                     int m_total, int S) {
  // a ref tile, then (S > 1) the rank's keys: key t of thread l at
  // [t * kThreads + l]
  static_assert(K * kThreads <= 4 * kTile, "keys > tile");
  __shared__ float4 smem[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nq * 3;
  ref += static_cast<size_t>(b) * m * 3;
  k_out += static_cast<size_t>(b) * nq * K;

  const int rank = blockIdx.x % S;  // the block's rank in its cluster
  const int qi = (blockIdx.x / S) * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) {
    qx = query[static_cast<size_t>(qi) * 3 + 0];
    qy = query[static_cast<size_t>(qi) * 3 + 1];
    qz = query[static_cast<size_t>(qi) * 3 + 2];
  }
  uint32_t keys[K];
#pragma unroll
  for (int t = 0; t < K; ++t) keys[t] = kStartF32;
  float bound = key_bound(kStartF32);

  // this rank's slice of the ref axis (empty when S exceeds m)
  const int chunk = (m + S - 1) / S;
  const int lo = min(m, rank * chunk);
  const int hi = min(m, lo + chunk);
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = ref + static_cast<size_t>(base + j) * 3;
      smem[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float d[kUnroll];
#pragma unroll
      for (int v = 0; v < kUnroll; ++v) {
        const float4 r = smem[j + v];
        d[v] = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      }
      float lowest = d[0];
#pragma unroll
      for (int v = 1; v < kUnroll; ++v) lowest = fminf(lowest, d[v]);
      if (lowest < bound) {
#pragma unroll
        for (int v = 0; v < kUnroll; ++v)
          if (d[v] < bound) offer<K>(keys, bound, d[v], base + j + v);
      }
    }
    for (; j < n; ++j) {
      const float4 r = smem[j];
      const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      if (d < bound) offer<K>(keys, bound, d, base + j);
    }
  }

  if (S > 1) {
    uint32_t* s_k = reinterpret_cast<uint32_t*>(smem);
    __syncthreads();  // the last tile is no longer read
    if (rank != 0) {
#pragma unroll
      for (int t = 0; t < K; ++t) s_k[t * kThreads + threadIdx.x] = keys[t];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // release the keys, acquire the other ranks'
    if (rank == 0) {
      for (int src = 1; src < S; ++src) {
        const uint32_t* rk = cluster.map_shared_rank(s_k, src);
#pragma unroll
        for (int t = 0; t < K; ++t)
          insert_key<K>(keys, rk[t * kThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // no rank exits while its keys are read
    if (rank != 0) return;
  }

  if (qi >= nq) return;
  // the padding refs: one place, ascending index, so k of them suffice
  const int n_pad = min(K, m_total - m);
  const float d_pad = sq_dist(qx, qy, qz, kFar, kFar, kFar);
  for (int t = 0; t < n_pad; ++t) offer<K>(keys, bound, d_pad, m + t);
#pragma unroll
  for (int t = 0; t < K; ++t) k_out[static_cast<size_t>(qi) * K + t] = keys[t];
}

template <int K>
cudaError_t launch_f32(const float* q, const float* r, uint32_t* keys,
                       int batch, int nq, int m, int m_total, int S,
                       cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, knn_f32packed_kernel<K>, q, r, keys, nq, m,
                            m_total, S);
}

// ---- int-packed keys ----

__device__ __forceinline__ int int_key(float d, int col, int idx_bits) {
  const uint32_t bits = static_cast<uint32_t>(__float_as_int(d));
  return static_cast<int>(((bits >> 16) << idx_bits) |
                          static_cast<uint32_t>(col));
}

template <int K>
__device__ __forceinline__ void insert_int(int (&keys)[K], float d, int col,
                                           int idx_bits) {
  const int key = int_key(d, col, idx_bits);
  if (d == d && key < keys[K - 1]) {  // a NaN is refused
    keys[K - 1] = key;
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      if (keys[t] < keys[t - 1]) {
        const int tmp = keys[t];
        keys[t] = keys[t - 1];
        keys[t - 1] = tmp;
      }
    }
  }
}

// grid (query blocks, batch); thread t of block g serves query g * kThreads
// + t over the whole ref axis.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_packed_kernel(const float* __restrict__ query,
                  const float* __restrict__ ref, int* __restrict__ k_out,
                  int nq, int m, int m_total, int idx_bits) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nq * 3;
  ref += static_cast<size_t>(b) * m * 3;
  k_out += static_cast<size_t>(b) * nq * K;

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[static_cast<size_t>(qi) * 3 + 0];
    qy = query[static_cast<size_t>(qi) * 3 + 1];
    qz = query[static_cast<size_t>(qi) * 3 + 2];
  }

  int keys[K];
#pragma unroll
  for (int t = 0; t < K; ++t) keys[t] = kStartInt;

  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = ref + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4 r = tile[j];
        insert_int<K>(keys, sq_dist(qx, qy, qz, r.x, r.y, r.z), base + j,
                      idx_bits);
      }
    }
  }

  if (active) {
    // the padding refs: one place, ascending index, so k of them suffice
    const int n_pad = min(K, m_total - m);
    const float d_pad = sq_dist(qx, qy, qz, kFar, kFar, kFar);
    for (int t = 0; t < n_pad; ++t) {
      insert_int<K>(keys, d_pad, m + t, idx_bits);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      k_out[static_cast<size_t>(qi) * K + t] = keys[t];
    }
  }
}

}  // namespace

// query [batch, nq, 3] f32, ref [batch, m, 3] f32 -> keys_out [batch, nq, k]
// (the bits of the f32-packed keys, ascending), all contiguous. m <= m_total
// <= 2^15: refs m..m_total-1 are padding points at 1e15. 1 <= k <= 16; S in
// {1, 2, 4, 8} ranks per cluster. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int pcst_knn_f32packed(const void* query, const void* ref,
                                  void* keys_out, int batch, int nq, int m,
                                  int m_total, int k, int S, void* stream) {
  if (m_total < m || m_total > (1 << 15) ||
      (S != 1 && S != 2 && S != 4 && S != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  uint32_t* o = static_cast<uint32_t*>(keys_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (k) {
#define PCST_K(KK) \
  case KK: err = launch_f32<KK>(q, r, o, batch, nq, m, m_total, S, s); break;
    PCST_K(1) PCST_K(2) PCST_K(3) PCST_K(4) PCST_K(5) PCST_K(6) PCST_K(7)
    PCST_K(8) PCST_K(9) PCST_K(10) PCST_K(11) PCST_K(12) PCST_K(13)
    PCST_K(14) PCST_K(15) PCST_K(16)
#undef PCST_K
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The int32 keys ((bits(d) >>> 16) << idx_bits) | index, ascending;
// 1 <= idx_bits <= 15 and m <= m_total <= 2^idx_bits; 1 <= k <= 16.
extern "C" int pcst_knn_packed(const void* query, const void* ref,
                               void* keys_out, int batch, int nq, int m,
                               int m_total, int idx_bits, int k,
                               void* stream) {
  if (m_total < m || idx_bits < 1 || idx_bits > 15 ||
      m_total > (1 << idx_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  int* o = static_cast<int*>(keys_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  switch (k) {
#define PCST_K(KK)                                                   \
  case KK:                                                           \
    knn_packed_kernel<KK><<<grid, kThreads, 0, s>>>(q, r, o, nq, m, \
                                                    m_total, idx_bits); \
    break;
    PCST_K(1) PCST_K(2) PCST_K(3) PCST_K(4) PCST_K(5) PCST_K(6) PCST_K(7)
    PCST_K(8) PCST_K(9) PCST_K(10) PCST_K(11) PCST_K(12) PCST_K(13)
    PCST_K(14) PCST_K(15) PCST_K(16)
#undef PCST_K
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
