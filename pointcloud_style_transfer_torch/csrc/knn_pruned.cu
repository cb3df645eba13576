// One pass of the Morton-pruned exact kNN: a running sorted top-k per query,
// initialised from a previous pass, over the ref tiles a skip list leaves.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/pruned_knn.py::
// _pruned_topk_kernel (driven twice by _run_pass from _pruned_knn_single).
// Queries and refs arrive sorted by Morton code and padded to whole tiles
// (tq queries, tr refs); skip[qi * nr + j] != 0 prunes ref tile j for query
// tile qi. Semantics kept bit for bit:
//   * distances rounded op by op as (dx*dx + dy*dy) + dz*dz;
//   * the running list starts at (d_init, i_init) and takes a candidate only
//     on strict '<' against its k-th entry, ref tiles in ascending order and
//     refs in ascending sorted position inside a tile. That is the order in
//     which the TPU kernel's per-tile extraction hands candidates over, so
//     ties resolve as there: an earlier pass's entry first, then the lowest
//     sorted position. A NaN distance is never taken;
//   * indices are sorted positions, written as they are (the caller clips
//     the padding refs' positions and maps back to ref ids).
//
// What bounds it on the card: operations, on the pairs the skip list leaves
// (8 float ops each); the inputs are about 1.5 MB. Design: a block of 128
// threads serves 128 queries of one query tile, so the skip flag is uniform
// over the block and is read once per block and ref tile; an unskipped ref
// tile streams through shared memory as float4 in chunks of 1,024; one thread
// per query keeps its top-k in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // refs staged per shared-memory chunk (16 KB)

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
knn_pruned_pass_kernel(const float* __restrict__ query,
                       const float* __restrict__ ref,
                       const int* __restrict__ skip,
                       const float* __restrict__ d_init,
                       const int* __restrict__ i_init,
                       float* __restrict__ d_out, int* __restrict__ i_out,
                       int tq, int tr, int nr) {
  __shared__ float4 chunk[kChunk];
  const int qi = blockIdx.x;  // the query tile
  const int within = blockIdx.y * kThreads + threadIdx.x;
  const bool active = within < tq;
  const size_t row = static_cast<size_t>(qi) * tq + within;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  float D[K];
  int I[K];
  if (active) {
    qx = query[row * 3 + 0];
    qy = query[row * 3 + 1];
    qz = query[row * 3 + 2];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      D[t] = d_init[row * K + t];
      I[t] = i_init[row * K + t];
    }
  } else {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      D[t] = 0.f;  // takes nothing
      I[t] = 0;
    }
  }

  for (int j = 0; j < nr; ++j) {
    if (__ldg(skip + static_cast<size_t>(qi) * nr + j) != 0) continue;
    for (int off = 0; off < tr; off += kChunk) {
      const int base = j * tr + off;
      const int n = min(kChunk, tr - off);
      __syncthreads();  // the previous chunk is no longer read
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const float* p = ref + static_cast<size_t>(base + c) * 3;
        chunk[c] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
      }
      __syncthreads();
      if (active) {
        for (int c = 0; c < n; ++c) {
          const float4 r = chunk[c];
          const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
          if (d < D[K - 1]) {
            D[K - 1] = d;
            I[K - 1] = base + c;
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
  }

  if (active) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d_out[row * K + t] = D[t];
      i_out[row * K + t] = I[t];
    }
  }
}

template <int K>
void launch(const float* q, const float* r, const int* skip, const float* d0,
            const int* i0, float* d, int* i, int nq, int nr, int tq, int tr,
            cudaStream_t stream) {
  const dim3 grid(nq, (tq + kThreads - 1) / kThreads);
  knn_pruned_pass_kernel<K><<<grid, kThreads, 0, stream>>>(
      q, r, skip, d0, i0, d, i, tq, tr, nr);
}

}  // namespace

// query [nq * tq, 3] f32 and ref [nr * tr, 3] f32 (Morton-sorted, padded to
// whole tiles), skip [nq * nr] i32, d_init/i_init [nq * tq, k] ->
// d_out/i_out [nq * tq, k], all contiguous; d_out/i_out may not alias the
// inputs. 1 <= k <= 16. Returns the CUDA error code of the launch.
extern "C" int pcst_knn_pruned_pass(const void* query, const void* ref,
                                    const void* skip, const void* d_init,
                                    const void* i_init, void* d_out,
                                    void* i_out, int nq, int nr, int tq,
                                    int tr, int k, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  const int* sk = static_cast<const int*>(skip);
  const float* d0 = static_cast<const float*>(d_init);
  const int* i0 = static_cast<const int*>(i_init);
  float* d = static_cast<float*>(d_out);
  int* i = static_cast<int*>(i_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || nr < 1 || tq < 1 || tr < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PCST_CASE(KK) \
  case KK: launch<KK>(q, r, sk, d0, i0, d, i, nq, nr, tq, tr, s); break;
  switch (k) {
    PCST_CASE(1) PCST_CASE(2) PCST_CASE(3) PCST_CASE(4) PCST_CASE(5)
    PCST_CASE(6) PCST_CASE(7) PCST_CASE(8) PCST_CASE(9) PCST_CASE(10)
    PCST_CASE(11) PCST_CASE(12) PCST_CASE(13) PCST_CASE(14) PCST_CASE(15)
    PCST_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PCST_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
