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
//     distance makes the row NaN, and the final clamp at 0 keeps it (no
//     fminf/fmaxf, which drop NaN);
//   * the result is clamped at >= 0.
//
// What bounds it on the card: operations. The compare CLI's call is 120,000 x
// 120,000 = 1.44e10 pairs (8 float ops each) against 2.9 MB of inputs. Design:
// one thread per query keeps its minimum in a register while the block streams
// ref tiles through shared memory as float4, one broadcast shared load per
// pair (the knn_topk.cu shape without the index). The TPU's 1e15 ref padding
// and tq/tr tiles have no counterpart: the scan stops at the last real ref.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads)
rowmin_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              float* __restrict__ out, int nq, int m) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nq * 3;
  ref += static_cast<size_t>(b) * m * 3;
  out += static_cast<size_t>(b) * nq;

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[static_cast<size_t>(qi) * 3 + 0];
    qy = query[static_cast<size_t>(qi) * 3 + 1];
    qz = query[static_cast<size_t>(qi) * 3 + 2];
  }

  float best = kBig;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* p = ref + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float4 r = tile[j];
        const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
        // strict '<' keeps the minimum; a NaN distance is taken and, once
        // held, never replaced (every comparison with it is false)
        if (d < best || d != d) best = d;
      }
    }
  }

  if (active) {
    // jnp.maximum(best, 0): NaN stays NaN
    out[qi] = (best > 0.f || best != best) ? best : 0.f;
  }
}

}  // namespace

// query [batch, nq, 3] f32, ref [batch, m, 3] f32 -> out [batch, nq] f32, all
// contiguous, m >= 1. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pcst_rowmin(const void* query, const void* ref, void* out,
                           int batch, int nq, int m, void* stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  rowmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<float*>(out), nq, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
