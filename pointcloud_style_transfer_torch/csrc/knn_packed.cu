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
// on any tiling. What is kept bit for bit:
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
// about 1.5 MB of inputs). Design as csrc/knn_topk.cu: one thread per query,
// its k keys sorted in registers, ref tiles staged through shared memory as
// float4. One compare and one insert chain per pair instead of the exact
// kernel's distance + index pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // refs staged per shared-memory tile (16 KB)
constexpr float kFar = 1e15f;  // the padding refs' coordinate
constexpr int kStartF32 = 0x7149F2CA;  // bits of 1e30f
constexpr int kStartInt = 1 << 30;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <bool F32>
__device__ __forceinline__ int make_key(float d, int col, int idx_bits) {
  const uint32_t bits = static_cast<uint32_t>(__float_as_int(d));
  if (F32) {
    return static_cast<int>(((bits + 0x00800000u) & ~0x7FFFu) |
                            static_cast<uint32_t>(col));
  }
  return static_cast<int>(((bits >> 16) << idx_bits) |
                          static_cast<uint32_t>(col));
}

template <bool F32>
__device__ __forceinline__ bool takes(float d, int key, int worst) {
  if (d != d) return false;  // NaN
  if (F32) {
    return static_cast<uint32_t>(key) < static_cast<uint32_t>(worst);
  }
  return key < worst;
}

template <int K, bool F32>
__device__ __forceinline__ void insert(int (&keys)[K], float d, int col,
                                       int idx_bits) {
  const int key = make_key<F32>(d, col, idx_bits);
  if (takes<F32>(d, key, keys[K - 1])) {
    keys[K - 1] = key;
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      // taken keys are non-negative, so a signed compare orders both kinds
      if (keys[t] < keys[t - 1]) {
        const int tmp = keys[t];
        keys[t] = keys[t - 1];
        keys[t - 1] = tmp;
      }
    }
  }
}

template <int K, bool F32>
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
  for (int t = 0; t < K; ++t) keys[t] = F32 ? kStartF32 : kStartInt;

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
        insert<K, F32>(keys, sq_dist(qx, qy, qz, r.x, r.y, r.z), base + j,
                       idx_bits);
      }
    }
  }

  if (active) {
    // the padding refs: one place, ascending index, so k of them suffice
    const int n_pad = min(K, m_total - m);
    const float d_pad = sq_dist(qx, qy, qz, kFar, kFar, kFar);
    for (int t = 0; t < n_pad; ++t) {
      insert<K, F32>(keys, d_pad, m + t, idx_bits);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      k_out[static_cast<size_t>(qi) * K + t] = keys[t];
    }
  }
}

template <int K, bool F32>
void launch(const float* q, const float* r, int* keys, int batch, int nq,
            int m, int m_total, int idx_bits, cudaStream_t stream) {
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  knn_packed_kernel<K, F32><<<grid, kThreads, 0, stream>>>(
      q, r, keys, nq, m, m_total, idx_bits);
}

template <bool F32>
int dispatch(const void* query, const void* ref, void* keys_out, int batch,
             int nq, int m, int m_total, int idx_bits, int k, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* r = static_cast<const float*>(ref);
  int* o = static_cast<int*>(keys_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_total < m || m_total > (1 << 15) || idx_bits < 1 || idx_bits > 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define PCST_CASE(KK) \
  case KK: launch<KK, F32>(q, r, o, batch, nq, m, m_total, idx_bits, s); break;
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

}  // namespace

// query [batch, nq, 3] f32, ref [batch, m, 3] f32 -> keys_out [batch, nq, k]
// (the bits of the f32-packed keys, ascending), all contiguous. m <= m_total
// <= 2^15: refs m..m_total-1 are padding points at 1e15. 1 <= k <= 16.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pcst_knn_f32packed(const void* query, const void* ref,
                                  void* keys_out, int batch, int nq, int m,
                                  int m_total, int k, void* stream) {
  return dispatch<true>(query, ref, keys_out, batch, nq, m, m_total, 15, k,
                        stream);
}

// The same with int32 keys ((bits(d) >>> 16) << idx_bits) | index,
// 1 <= idx_bits <= 15 and m_total <= 2^idx_bits.
extern "C" int pcst_knn_packed(const void* query, const void* ref,
                               void* keys_out, int batch, int nq, int m,
                               int m_total, int idx_bits, int k,
                               void* stream) {
  if (m_total > (1 << idx_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<false>(query, ref, keys_out, batch, nq, m, m_total,
                         idx_bits, k, stream);
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
