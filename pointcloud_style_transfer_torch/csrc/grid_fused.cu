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
//     order the slots come in;
//   * interpolation: w_u = 1/(sqrt(max(d_u, 0)) + eps), wsum = (w_0 + w_1)
//     + ..., v_c = sum_u (w_u / wsum) * vals[pos_u, c], summed in u order;
//   * top-k positions clipped to [0, m_pad - 1].
//
// What bounds it on the card: operations. At the sampler's shapes (896
// tiles of 128 queries, three y-run slots, about 1,230 candidates a tile)
// the real queries need 1.14e8 pairs of 8 float ops (0.014 ms at the
// float32 peak) against about 3 MB of inputs and outputs; an H100 runs the
// launch in about 0.14 ms (chip_smoke.py). Design: one block per tile, one
// thread per query, its top-k in registers (unrolled insert, no local
// memory); the block stages each slot's run of refs through shared memory
// as float4, so each pair costs one broadcast shared load. The TPU kernel's
// 128-aligned windows, scalar prefetch and VMEM-resident ref array have no
// counterpart: the block reads its own slot row and scans [st, en) exactly.
// The values are not staged: the epilogue reads the k selected rows of
// vals from global memory (30k x 3 floats stay in L2), which is k*C loads a
// query instead of one per candidate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;  // tq: one thread per query of a tile
constexpr int kChunk = 1024;       // refs staged per shared-memory pass (16 KB)
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (d, p) before (e, q): lexicographic on (distance, sorted position)
__device__ __forceinline__ bool before(float d, int p, float e, int q) {
  return d < e || (d == e && p < q);
}

// The top-k of the tile's candidates for this thread's query, ascending.
template <int K>
__device__ __forceinline__ void scan_slots(
    const float* __restrict__ q_pad, const float* __restrict__ refs,
    const int* __restrict__ st_tab, const int* __restrict__ en_tab,
    int n_slots, int m_pad, float4* stage, float (&D)[K], int (&I)[K]) {
  const int tile = blockIdx.x;
  const size_t qi = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const float qx = q_pad[qi * 3 + 0];
  const float qy = q_pad[qi * 3 + 1];
  const float qz = q_pad[qi * 3 + 2];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    D[t] = kBig;
    I[t] = 0;
  }
  for (int s = 0; s < n_slots; ++s) {
    const size_t slot = static_cast<size_t>(tile) * n_slots + s;
    const int st = max(__ldg(st_tab + slot), 0);
    const int en = min(__ldg(en_tab + slot), m_pad);
    for (int base = st; base < en; base += kChunk) {
      const int n = min(kChunk, en - base);
      __syncthreads();  // the previous chunk is no longer read
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const float* p = refs + static_cast<size_t>(base + j) * 3;
        stage[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float4 r = stage[j];
        const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
        const int p = base + j;
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
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
grid_interp_kernel(const float* __restrict__ q_pad,
                   const float* __restrict__ refs,
                   const float* __restrict__ vals,
                   const int* __restrict__ st_tab,
                   const int* __restrict__ en_tab, float* __restrict__ v_out,
                   float* __restrict__ d_out, int n_slots, int m_pad,
                   int n_chan, float eps) {
  __shared__ float4 stage[kChunk];
  float D[K];
  int I[K];
  scan_slots<K>(q_pad, refs, st_tab, en_tab, n_slots, m_pad, stage, D, I);

  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float w[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    w[u] = __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(D[u], 0.f)), eps));
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
__global__ void __launch_bounds__(kMaxThreads)
grid_topk_kernel(const float* __restrict__ q_pad,
                 const float* __restrict__ refs,
                 const int* __restrict__ st_tab,
                 const int* __restrict__ en_tab, float* __restrict__ d_out,
                 int* __restrict__ i_out, int n_slots, int m_pad) {
  __shared__ float4 stage[kChunk];
  float D[K];
  int I[K];
  scan_slots<K>(q_pad, refs, st_tab, en_tab, n_slots, m_pad, stage, D, I);

  const size_t qi = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    d_out[qi * K + u] = D[u];
    i_out[qi * K + u] = min(max(I[u], 0), m_pad - 1);
  }
}

bool bad_shape(int n_tiles, int tq, int n_slots, int m_pad) {
  return n_tiles < 1 || tq < 1 || tq > kMaxThreads || n_slots < 0 ||
         m_pad < 1;
}

}  // namespace

// q_pad [n_tiles*tq, 3] f32, refs [m_pad, 3] f32, vals [m_pad, n_chan] f32,
// st/en [n_tiles, n_slots] i32 -> v_out [n_tiles*tq, n_chan] f32,
// d_out [n_tiles*tq, k] f32, all contiguous. 1 <= k <= 8, 1 <= tq <= 1024.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pcst_grid_interp(const void* q_pad, const void* refs,
                                const void* vals, const void* st,
                                const void* en, void* v_out, void* d_out,
                                int n_tiles, int tq, int n_slots, int m_pad,
                                int n_chan, int k, float eps, void* stream) {
  if (bad_shape(n_tiles, tq, n_slots, m_pad) || n_chan < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(q_pad);
  const float* r = static_cast<const float*>(refs);
  const float* v = static_cast<const float*>(vals);
  const int* s = static_cast<const int*>(st);
  const int* e = static_cast<const int*>(en);
  float* vo = static_cast<float*>(v_out);
  float* d = static_cast<float*>(d_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define PCST_INTERP(K)                                                     \
  grid_interp_kernel<K><<<n_tiles, tq, 0, cs>>>(q, r, v, s, e, vo, d,      \
                                                n_slots, m_pad, n_chan, eps)
  switch (k) {
    case 1: PCST_INTERP(1); break;
    case 2: PCST_INTERP(2); break;
    case 3: PCST_INTERP(3); break;
    case 4: PCST_INTERP(4); break;
    case 5: PCST_INTERP(5); break;
    case 6: PCST_INTERP(6); break;
    case 7: PCST_INTERP(7); break;
    case 8: PCST_INTERP(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PCST_INTERP
  return static_cast<int>(cudaGetLastError());
}

// q_pad [n_tiles*tq, 3] f32, refs [m_pad, 3] f32, st/en [n_tiles, n_slots]
// i32 -> d_out [n_tiles*tq, k] f32, i_out [n_tiles*tq, k] i32 (sorted
// positions), all contiguous. 1 <= k <= 8, 1 <= tq <= 1024. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pcst_grid_topk(const void* q_pad, const void* refs,
                              const void* st, const void* en, void* d_out,
                              void* i_out, int n_tiles, int tq, int n_slots,
                              int m_pad, int k, void* stream) {
  if (bad_shape(n_tiles, tq, n_slots, m_pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(q_pad);
  const float* r = static_cast<const float*>(refs);
  const int* s = static_cast<const int*>(st);
  const int* e = static_cast<const int*>(en);
  float* d = static_cast<float*>(d_out);
  int* i = static_cast<int*>(i_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define PCST_TOPK(K)                                                       \
  grid_topk_kernel<K><<<n_tiles, tq, 0, cs>>>(q, r, s, e, d, i, n_slots,  \
                                              m_pad)
  switch (k) {
    case 1: PCST_TOPK(1); break;
    case 2: PCST_TOPK(2); break;
    case 3: PCST_TOPK(3); break;
    case 4: PCST_TOPK(4); break;
    case 5: PCST_TOPK(5); break;
    case 6: PCST_TOPK(6); break;
    case 7: PCST_TOPK(7); break;
    case 8: PCST_TOPK(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PCST_TOPK
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
