// Exact brute-force k nearest neighbours: squared distances + indices.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::_topk_kernel
// (wrappers _knn_single / pallas_knn). Semantics kept bit for bit:
//   * distances in squared-difference form, rounded op by op as
//     (dx*dx + dy*dy) + dz*dz (the __f*_rn intrinsics stop nvcc from
//     contracting them into FMAs, so the plain PyTorch version reproduces
//     every bit);
//   * a running sorted top-k that starts at (1e30, index 0) and takes a
//     candidate only on strict '<', scanning refs in ascending index order,
//     so ties resolve to the lowest ref index;
//   * indices clipped to [0, M-1].
//
// What bounds it on the card: operations, 8 float ops per pair that may not
// be contracted into FMAs, so the floor is the card's FP32 issue rate, not
// its FMA peak. The sampler's brute path asks 90,000 x 30,000 pairs; the
// kd-grid's patches ask a few thousand queries x 30,000, which one thread
// per query spreads over only ~20 of the 132 SMs.
//
// Design: one thread per query, its top-k in registers; the cluster size S
// is the caller's plan:
//   * a thread-block cluster of S blocks serves one block of queries; rank r
//     scans the r-th contiguous slice of the ref axis (slices ascend with the
//     rank), so small query counts still fill the card;
//   * refs stream through shared memory in tiles, each pair one broadcast
//     shared load; the scan takes them eight at a time and tries the
//     inserts only when the smallest of them beats the k-th distance;
//   * the merge, in one launch: ranks 1..S-1 write their lists to their own
//     shared memory, and after a cluster barrier rank 0 reads them in rank
//     order through distributed shared memory and inserts their entries in
//     list order with the same strict '<'. A later rank's slice holds only
//     higher indices and each list is sorted by (distance, index), so an
//     equal distance arriving later has the higher index and is refused: the
//     result is the (distance, index)-lexicographic k smallest, as one scan
//     gives. A second barrier keeps every rank alive while it is read.
// The count on the device (the kd-grid's fallback ladder, whose patch size is
// not known on the host): a launch may take a per-cloud int32 count of the
// rows it serves and an int32 row-index array through which it gathers its
// query rows. The decision to skip is taken per query block (blockIdx.x / S),
// the same for every rank of a cluster, so a cluster whose rows all lie at or
// past the count exits before either barrier and one that straddles it
// arrives at both. A row at or past the count gets the start list
// (1e30, 0), so every output row is defined.
// Above k = 16 the lists leave the registers: knn_topk_global_kernel keeps
// each query's sorted list in the output buffer itself (global memory, hot
// in L1 and L2) and only its k-th distance in a register, with the same
// ascending scan, eight-ref filter and strict '<', and no cluster. An insert
// shifts the entries above it up by one, which is what the register
// version's swap network does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile (16 KB)
constexpr int kUnroll = 8;   // refs tried together before any insert
constexpr float kBig = 1e30f;

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

// The start list (1e30, 0) of a row that is not computed.
__device__ __forceinline__ void write_start(float* d_out, int* i_out, int qi,
                                            int k) {
  for (int t = 0; t < k; ++t) {
    d_out[static_cast<size_t>(qi) * k + t] = kBig;
    i_out[static_cast<size_t>(qi) * k + t] = 0;
  }
}

// Sorted insert on strict '<' (a NaN never passes).
template <int K>
__device__ __forceinline__ void insert(float (&D)[K], int (&I)[K], float d,
                                       int idx) {
  if (d < D[K - 1]) {
    D[K - 1] = d;
    I[K - 1] = idx;
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      if (D[t] < D[t - 1]) {
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

// grid (query blocks * S, batch), clusters of (S, 1, 1); thread t of query
// block g serves output row g * kThreads + t, which reads query row
// rows[b * nq + that] (or itself without rows) of the nsrc rows of cloud b;
// rows at or past count[b] (nq without count) are not computed. (The minimum of one block per SM
// lets ptxas give k = 3 48 registers rather than 34; with 34 a block that
// has its SM to itself scanned 1.2x slower, PERF.md PR 5.)
template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_topk_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                float* __restrict__ d_out, int* __restrict__ i_out,
                const int* __restrict__ rows, const int* __restrict__ count,
                int nq, int nsrc, int m, int S) {
  // a ref tile, then (S > 1) the rank's lists: list t of query l at
  // s_d[t * kThreads + l], s_i likewise; the tile is the larger
  __shared__ float4 smem[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nsrc * 3;
  ref += static_cast<size_t>(b) * m * 3;
  d_out += static_cast<size_t>(b) * nq * K;
  i_out += static_cast<size_t>(b) * nq * K;

  const int rank = blockIdx.x % S;  // the block's rank in its cluster
  const int block0 = static_cast<int>(blockIdx.x) / S * kThreads;  // 1st row
  const int qi = block0 + threadIdx.x;
  const int n_rows = row_count(count, b, nq);
  if (block0 >= n_rows) {  // the whole cluster: no row of it is computed
    if (rank == 0 && qi < nq) write_start(d_out, i_out, qi, K);
    return;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < n_rows) {
    const size_t src = query_row(rows, b, nq, nsrc, qi);
    qx = query[src * 3 + 0];
    qy = query[src * 3 + 1];
    qz = query[src * 3 + 2];
  }

  float D[K];
  int I[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    D[t] = kBig;
    I[t] = 0;
  }

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
      float4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = smem[j + u];
      float d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        d[u] = sq_dist(qx, qy, qz, r[u].x, r[u].y, r[u].z);
      // fminf drops a NaN; the inserts below refuse it on their own
      float lowest = d[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) lowest = fminf(lowest, d[u]);
      if (lowest < D[K - 1]) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) insert<K>(D, I, d[u], base + j + u);
      }
    }
    for (; j < n; ++j) {
      const float4 r = smem[j];
      insert<K>(D, I, sq_dist(qx, qy, qz, r.x, r.y, r.z), base + j);
    }
  }

  if (S > 1) {
    float* s_d = reinterpret_cast<float*>(smem);
    int* s_i = reinterpret_cast<int*>(s_d + K * kThreads);
    __syncthreads();  // the last tile is no longer read
    if (rank != 0) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        s_d[t * kThreads + threadIdx.x] = D[t];
        s_i[t * kThreads + threadIdx.x] = I[t];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // release the lists, acquire the other ranks'
    if (rank == 0) {
      for (int src = 1; src < S; ++src) {
        const float* rd = cluster.map_shared_rank(s_d, src);
        const int* ri = cluster.map_shared_rank(s_i, src);
#pragma unroll
        for (int t = 0; t < K; ++t)
          insert<K>(D, I, rd[t * kThreads + threadIdx.x],
                    ri[t * kThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // no rank exits while its lists are read
    if (rank != 0) return;
  }

  if (qi < n_rows) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d_out[static_cast<size_t>(qi) * K + t] = D[t];
      i_out[static_cast<size_t>(qi) * K + t] = min(max(I[t], 0), m - 1);
    }
  } else if (qi < nq) {
    write_start(d_out, i_out, qi, K);
  }
}

// The sorted insert of d into a global list of k entries on strict '<';
// returns the new k-th distance.
__device__ __forceinline__ float insert_global(float* D, int* I, int k,
                                               float d, int idx) {
  int t = k - 1;
  while (t > 0 && d < D[t - 1]) {
    D[t] = D[t - 1];
    I[t] = I[t - 1];
    --t;
  }
  D[t] = d;
  I[t] = idx;
  return D[k - 1];
}

// grid (query blocks, batch), no cluster; any k >= 1. Thread t of query
// block g serves output row qi = g * kThreads + t, its list at
// d_out/i_out [qi, :]; rows and count as in knn_topk_kernel.
__global__ void __launch_bounds__(kThreads)
knn_topk_global_kernel(const float* __restrict__ query,
                       const float* __restrict__ ref,
                       float* __restrict__ d_out, int* __restrict__ i_out,
                       const int* __restrict__ rows,
                       const int* __restrict__ count, int nq, int nsrc,
                       int m, int k) {
  __shared__ float4 smem[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nsrc * 3;
  ref += static_cast<size_t>(b) * m * 3;
  d_out += static_cast<size_t>(b) * nq * k;
  i_out += static_cast<size_t>(b) * nq * k;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int n_rows = row_count(count, b, nq);
  if (static_cast<int>(blockIdx.x) * kThreads >= n_rows) {  // nothing to scan
    if (qi < nq) write_start(d_out, i_out, qi, k);
    return;
  }
  const bool active = qi < n_rows;
  float* D = d_out + static_cast<size_t>(qi) * k;
  int* I = i_out + static_cast<size_t>(qi) * k;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) write_start(d_out, i_out, qi, k);
  if (active) {
    const size_t src = query_row(rows, b, nq, nsrc, qi);
    qx = query[src * 3 + 0];
    qy = query[src * 3 + 1];
    qz = query[src * 3 + 2];
  }
  float kth = kBig;

  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = ref + static_cast<size_t>(base + j) * 3;
      smem[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    if (!active) continue;
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      float d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 r = smem[j + u];
        d[u] = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      }
      float lowest = d[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) lowest = fminf(lowest, d[u]);
      if (lowest < kth) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (d[u] < kth) kth = insert_global(D, I, k, d[u], base + j + u);
      }
    }
    for (; j < n; ++j) {
      const float4 r = smem[j];
      const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
      if (d < kth) kth = insert_global(D, I, k, d, base + j);
    }
  }
  if (active) {
    for (int t = 0; t < k; ++t) I[t] = min(max(I[t], 0), m - 1);
  }
}

// 16 lists of kThreads (distance, index) pairs fit the tile
static_assert(16 * kThreads * 8 <= kTile * sizeof(float4), "lists > tile");

template <int K>
cudaError_t launch(const float* q, const float* r, float* d, int* i,
                   const int* rows, const int* count, int batch, int nq,
                   int nsrc, int m, int S, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, knn_topk_kernel<K>, q, r, d, i, rows, count,
                            nq, nsrc, m, S);
}

}  // namespace

// query [batch, nsrc, 3] f32, ref [batch, m, 3] f32 -> d_out [batch, nq, k]
// f32, i_out [batch, nq, k] i32, all contiguous. rows (nullable): [batch, nq]
// i32, the query row each output row reads (else row qi reads query row qi,
// and nsrc must be nq); count (nullable): [batch] i32 on the device, the
// output rows of each cloud that are computed (the rest get (1e30, 0)). k >= 1;
// S in {1, 2, 4, 8} ranks per cluster for k <= 16, S = 1 above. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pcst_knn_topk(const void* query, const void* ref, void* d_out,
                             void* i_out, const void* rows, const void* count,
                             int batch, int nq, int nsrc, int m, int k, int S,
                             void* stream) {
  if ((S != 1 && S != 2 && S != 4 && S != 8) || k < 1 || (k > 16 && S != 1) ||
      nsrc < 1 || (rows == nullptr && nsrc != nq))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  float* d = static_cast<float*>(d_out);
  int* i = static_cast<int*>(i_out);
  const int* rw = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (k > 16) {
    knn_topk_global_kernel<<<dim3((nq + kThreads - 1) / kThreads, batch),
                             kThreads, 0, s>>>(q, r, d, i, rw, c, nq, nsrc, m,
                                               k);
    return static_cast<int>(cudaGetLastError());
  }
  switch (k) {
#define PCST_K(KK) \
  case KK:                                                            \
    err = launch<KK>(q, r, d, i, rw, c, batch, nq, nsrc, m, S, s);    \
    break;
    PCST_K(1) PCST_K(2) PCST_K(3) PCST_K(4) PCST_K(5) PCST_K(6) PCST_K(7)
    PCST_K(8) PCST_K(9) PCST_K(10) PCST_K(11) PCST_K(12) PCST_K(13)
    PCST_K(14) PCST_K(15) PCST_K(16)
#undef PCST_K
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
