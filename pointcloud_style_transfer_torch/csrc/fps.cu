// Farthest point sampling, one thread block per cloud.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/fps.py::_fps_kernel
// (wrappers _fps_single / pallas_farthest_point_sample). Semantics kept bit
// for bit:
//   * the current index is stored before the distances are updated, starting
//     from the caller's start index;
//   * every point's running distance starts at 1e10 and takes
//     min(dist, (dx*dx + dy*dy) + dz*dz), rounded op by op (__f*_rn: no FMA
//     contraction, so the plain PyTorch version reproduces every bit);
//   * the next index is the LOWEST index reaching the maximum distance: the
//     block reduction compares (value, index) pairs and keeps the smaller
//     index on equal values (float atomics could not give that).
//
// What bounds it on the card: latency. npoint iterations depend on each other
// (512 for the encoder's 30k -> 512 call), each a pass over the cloud and a
// block-wide argmax, so neither bytes nor operations set its time. The TPU
// kernel keeps the cloud and its distances resident in VMEM; 30k points x 16 B
// do not fit one SM's 227 KB of shared memory, so here each thread keeps its
// slice of the distances in registers (PER per thread, unrolled) and re-reads
// the coordinates from L2 (360 KB per iteration for 30k points). Two block
// barriers per iteration carry the argmax.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kInitDist = 1e10f;

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Keep the larger value; on equal values the lower index.
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_max(v, i, ov, oi);
  }
}

// Point i of the cloud belongs to thread i % kThreads, register slot
// i / kThreads; PER * kThreads >= n.
template <int PER>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int n, int npoint) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_far;

  const int b = blockIdx.x;
  xyz += static_cast<size_t>(b) * n * 3;
  out += static_cast<size_t>(b) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) dist[j] = kInitDist;

  int farthest = start[b];
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) out[it] = farthest;
    const float* c = xyz + static_cast<size_t>(farthest) * 3;
    const float cx = __ldg(c), cy = __ldg(c + 1), cz = __ldg(c + 2);

    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = j * kThreads + tid;
      if (i < n) {
        const float* p = xyz + static_cast<size_t>(i) * 3;
        const float d = sq_dist(__ldg(p), __ldg(p + 1), __ldg(p + 2), cx, cy, cz);
        dist[j] = fminf(dist[j], d);
        if (dist[j] > best) {  // strict: the thread's lowest index wins ties
          best = dist[j];
          best_i = i;
        }
      }
    }

    warp_argmax(best, best_i);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      best_i = s_idx[lane];
      warp_argmax(best, best_i);
      if (lane == 0) s_far = best_i;
    }
    __syncthreads();
    farthest = s_far;
  }
}

template <int PER>
void launch(const float* xyz, const int* start, int* out, int batch, int n,
            int npoint, cudaStream_t stream) {
  fps_kernel<PER><<<batch, kThreads, 0, stream>>>(xyz, start, out, n, npoint);
}

}  // namespace

// xyz [batch, n, 3] f32, start [batch] i32 (each in [0, n)) -> out
// [batch, npoint] i32, all contiguous. n <= 64 * 1024. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int pcst_fps(const void* xyz, const void* start, void* out,
                        int batch, int n, int npoint, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (n + kThreads - 1) / kThreads;
  if (per <= 1) launch<1>(x, st, o, batch, n, npoint, s);
  else if (per <= 2) launch<2>(x, st, o, batch, n, npoint, s);
  else if (per <= 4) launch<4>(x, st, o, batch, n, npoint, s);
  else if (per <= 8) launch<8>(x, st, o, batch, n, npoint, s);
  else if (per <= 16) launch<16>(x, st, o, batch, n, npoint, s);
  else if (per <= 32) launch<32>(x, st, o, batch, n, npoint, s);
  else if (per <= 64) launch<64>(x, st, o, batch, n, npoint, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
