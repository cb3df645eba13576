// Row minimum of squared distance: for each query, min over refs of |q - r|^2.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::_rowmin_kernel
// (wrappers _rowmin_single / pallas_min_sq_dist, the primal of the Chamfer
// VJP). Semantics kept bit for bit:
//   * distances in squared-difference form, rounded op by op as
//     (dx*dx + dy*dy) + dz*dz (the __f*_rn intrinsics stop nvcc from
//     contracting them into FMAs), so the plain PyTorch version reproduces
//     every bit; a minimum of non-NaN floats does not depend on the order of
//     the scan, so the values are identical, not merely close;
//   * the running minimum starts at 1e30, as the TPU kernel's scratch does;
//   * NaN propagates as jnp.minimum / jnp.maximum propagate it: one NaN
//     distance makes the row NaN, and the final clamp at 0 keeps it;
//   * the result is clamped at >= 0 (distances are sums of squares, never
//     -0, so the minimum of two zeros is the same +0 in any order).
//
// What bounds it on the card: operations at the FP32 issue rate. The compare
// CLI's call is 120,000 x 120,000 = 1.44e10 pairs of 8 float ops against
// 2.9 MB of inputs, and the contract keeps the 8 ops out of FMAs, so the
// floor is 8 issued instructions a pair at 128 a clock on each SM. The first
// design issued ~12 a pair (a broadcast shared load, the 8 ops, two
// compares and a select for the NaN-keeping minimum), 48% of that floor, and
// the Chamfer's 30,000 x 30,000 gave 235 blocks of 128 threads to 132 SMs.
//
// Design: one thread keeps kQ queries' minima in registers while the block
// streams ref tiles through shared memory as float4; each staged ref (one
// broadcast LDS.128) serves the thread's kQ queries, and the NaN-keeping
// minimum is one instruction, PTX min.NaN.f32 (sm_80 and later): about
// 9 + 1/kQ instructions a pair. A thread-block cluster of kS blocks splits
// the ref axis, rank r scanning the r-th ascending slice (as
// csrc/knn_topk.cu does), so that the Chamfer's 30,000 x 30,000 gives the
// card 472 blocks; rank 0 merges the ranks' minima through distributed
// shared memory with the same min.NaN, so a call stays one launch. kS and kQ
// are constants of the source, chosen with tools/sweep_kernel_plans.py
// ([rowmin sweep]), which rebuilds it with -DPCST_ROWMIN_S=s
// -DPCST_ROWMIN_Q=q: (kS, kQ) = (8, 4) was the fastest or within 1.3% of
// it at 120,000, 30,000 and 4,096 points on an H100, and kS = 8 the
// fastest cluster size at each (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef PCST_ROWMIN_S
#define PCST_ROWMIN_S 8
#endif
#ifndef PCST_ROWMIN_Q
#define PCST_ROWMIN_Q 4
#endif

namespace {

constexpr int kS = PCST_ROWMIN_S;  // blocks per cluster, one ref slice each
constexpr int kQ = PCST_ROWMIN_Q;  // queries per thread
constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile (16 KB)
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// min / max that return NaN when either operand is NaN (jnp.minimum /
// jnp.maximum), one instruction each
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// grid (query blocks * kS, batch), clusters of (kS, 1, 1). Query block g
// holds kThreads * kQ queries: thread t serves g * kThreads * kQ +
// u * kThreads + t for u < kQ (neighbouring threads on neighbouring queries).
__global__ void __cluster_dims__(kS, 1, 1) __launch_bounds__(kThreads)
rowmin_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              float* __restrict__ out, int nq, int m) {
  // a ref tile, then (kS > 1) the rank's minima: query u of thread t at
  // [u * kThreads + t]
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nq * 3;
  ref += static_cast<size_t>(b) * m * 3;
  out += static_cast<size_t>(b) * nq;

  const int rank = blockIdx.x % kS;  // the block's rank in its cluster
  const int q0 = (blockIdx.x / kS) * kThreads * kQ + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = q0 + u * kThreads;
    qx[u] = qy[u] = qz[u] = 0.f;  // a padding query: scanned, not written
    if (qi < nq) {
      qx[u] = query[static_cast<size_t>(qi) * 3 + 0];
      qy[u] = query[static_cast<size_t>(qi) * 3 + 1];
      qz[u] = query[static_cast<size_t>(qi) * 3 + 2];
    }
    best[u] = kBig;
  }

  // this rank's slice of the ref axis (empty when kS exceeds m)
  const int chunk = (m + kS - 1) / kS;
  const int lo = min(m, rank * chunk);
  const int hi = min(m, lo + chunk);
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = ref + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 r = tile[j];
#pragma unroll
      for (int u = 0; u < kQ; ++u)
        best[u] = min_nan(best[u], sq_dist(qx[u], qy[u], qz[u], r.x, r.y,
                                           r.z));
    }
  }

  if constexpr (kS > 1) {
    float* s_best = reinterpret_cast<float*>(tile);
    __syncthreads();  // the last tile is no longer read
    if (rank != 0) {
#pragma unroll
      for (int u = 0; u < kQ; ++u)
        s_best[u * kThreads + threadIdx.x] = best[u];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // release the minima, acquire the other ranks'
    if (rank == 0) {
      for (int src = 1; src < kS; ++src) {
        const float* rb = cluster.map_shared_rank(s_best, src);
#pragma unroll
        for (int u = 0; u < kQ; ++u)
          best[u] = min_nan(best[u], rb[u * kThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // no rank exits while its minima are read
    if (rank != 0) return;
  }

#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = q0 + u * kThreads;
    if (qi < nq) out[qi] = max_nan(best[u], 0.f);  // jnp.maximum(best, 0)
  }
}

static_assert(kQ >= 1 && kQ * kThreads * 4 <= kTile * sizeof(float4),
              "the minima do not fit the tile");
static_assert(kS == 1 || kS == 2 || kS == 4 || kS == 8,
              "a portable cluster size");

}  // namespace

// query [batch, nq, 3] f32, ref [batch, m, 3] f32 -> out [batch, nq] f32, all
// contiguous, m >= 1. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pcst_rowmin(const void* query, const void* ref, void* out,
                           int batch, int nq, int m, void* stream) {
  const int per_block = kThreads * kQ;
  const dim3 grid(((nq + per_block - 1) / per_block) * kS, batch, 1);
  rowmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<float*>(out), nq, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
