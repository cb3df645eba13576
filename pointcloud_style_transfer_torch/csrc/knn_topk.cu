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
// What bounds it on the card: operations. The sampler's call is 90,000
// queries x 30,000 refs = 2.7e9 pairs (8 float ops each) against about 1.5 MB
// of inputs, so it is compute-bound. Design: one thread per query, its top-k
// in registers (the sorted insert is unrolled, no local memory); the block
// streams ref tiles through shared memory as float4 so each pair costs one
// broadcast shared load. The ref axis is not split across threads, which keeps
// the tie rule trivially right; that caps the launch at one thread per query
// (90k threads, about a third of the card's resident-thread capacity).

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

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                float* __restrict__ d_out, int* __restrict__ i_out, int nq,
                int m) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  query += static_cast<size_t>(b) * nq * 3;
  ref += static_cast<size_t>(b) * m * 3;
  d_out += static_cast<size_t>(b) * nq * K;
  i_out += static_cast<size_t>(b) * nq * K;

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[static_cast<size_t>(qi) * 3 + 0];
    qy = query[static_cast<size_t>(qi) * 3 + 1];
    qz = query[static_cast<size_t>(qi) * 3 + 2];
  }

  float D[K];
  int I[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    D[t] = kBig;
    I[t] = 0;
  }

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
        const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
        if (d < D[K - 1]) {
          D[K - 1] = d;
          I[K - 1] = base + j;
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
    }
  }

  if (active) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d_out[static_cast<size_t>(qi) * K + t] = D[t];
      i_out[static_cast<size_t>(qi) * K + t] = min(max(I[t], 0), m - 1);
    }
  }
}

template <int K>
void launch(const float* q, const float* r, float* d, int* i, int batch,
            int nq, int m, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  knn_topk_kernel<K><<<grid, kThreads, 0, stream>>>(q, r, d, i, nq, m);
}

}  // namespace

// query [batch, nq, 3] f32, ref [batch, m, 3] f32 -> d_out [batch, nq, k] f32,
// i_out [batch, nq, k] i32, all contiguous. 1 <= k <= 16. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pcst_knn_topk(const void* query, const void* ref, void* d_out,
                             void* i_out, int batch, int nq, int m, int k,
                             void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  float* d = static_cast<float*>(d_out);
  int* i = static_cast<int*>(i_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(q, r, d, i, batch, nq, m, s); break;
    case 2: launch<2>(q, r, d, i, batch, nq, m, s); break;
    case 3: launch<3>(q, r, d, i, batch, nq, m, s); break;
    case 4: launch<4>(q, r, d, i, batch, nq, m, s); break;
    case 5: launch<5>(q, r, d, i, batch, nq, m, s); break;
    case 6: launch<6>(q, r, d, i, batch, nq, m, s); break;
    case 7: launch<7>(q, r, d, i, batch, nq, m, s); break;
    case 8: launch<8>(q, r, d, i, batch, nq, m, s); break;
    case 9: launch<9>(q, r, d, i, batch, nq, m, s); break;
    case 10: launch<10>(q, r, d, i, batch, nq, m, s); break;
    case 11: launch<11>(q, r, d, i, batch, nq, m, s); break;
    case 12: launch<12>(q, r, d, i, batch, nq, m, s); break;
    case 13: launch<13>(q, r, d, i, batch, nq, m, s); break;
    case 14: launch<14>(q, r, d, i, batch, nq, m, s); break;
    case 15: launch<15>(q, r, d, i, batch, nq, m, s); break;
    case 16: launch<16>(q, r, d, i, batch, nq, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
