// Ball query: the nsample lowest-index points within a radius of each center.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
// _ballquery_kernel (wrappers _ballquery_single / pallas_ball_query).
// Semantics kept bit for bit:
//   * a point is inside when (dx*dx + dy*dy) + dz*dz <= radius_sq, rounded op
//     by op (__f*_rn: no FMA contraction), radius_sq being float32(r*r);
//   * the output row holds the in-radius indices in ascending order, then the
//     empty slots take the row's first index; a row with no point inside
//     stays at the sentinel n (the caller's gather clamps it).
//
// What bounds it on the card: latency. The encoder's calls are 512 x 30,000
// (r 0.2, ns 32) and 128 x 512 (r 0.4, ns 64): a few hundred independent
// scans, far too few to fill the card's bandwidth or ALUs. Design: one warp
// per center scans the points 32 at a time in ascending index order; a
// __ballot_sync / __popc prefix appends the in-radius indices in order
// without any sort, and the warp stops as soon as nsample slots are full. The
// points are read straight from L2 (coalesced 384 B per warp step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ centers,
                  const float* __restrict__ points, int* __restrict__ out,
                  int s, int n, int nsample, float radius_sq) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= s) return;  // whole warp: c is warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;

  const float* q = centers + (static_cast<size_t>(b) * s + c) * 3;
  const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
  const float* p = points + static_cast<size_t>(b) * n * 3;
  int* o = out + (static_cast<size_t>(b) * s + c) * nsample;

  int count = 0;
  int first = n;  // sentinel until the first in-radius point
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int i = base + lane;
    bool inside = false;
    if (i < n) {
      const float* pi = p + static_cast<size_t>(i) * 3;
      inside = sq_dist(qx, qy, qz, __ldg(pi), __ldg(pi + 1), __ldg(pi + 2)) <=
               radius_sq;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, inside);
    const int pos = count + __popc(mask & lanes_below);
    if (inside && pos < nsample) o[pos] = i;
    if (count == 0 && mask != 0u) first = base + __ffs(mask) - 1;
    count += __popc(mask);
  }
  for (int j = min(count, nsample) + lane; j < nsample; j += 32) o[j] = first;
}

}  // namespace

// centers [batch, s, 3] f32, points [batch, n, 3] f32 -> out [batch, s,
// nsample] i32, all contiguous. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int pcst_ball_query(const void* centers, const void* points,
                               void* out, int batch, int s, int n, int nsample,
                               float radius_sq, void* stream) {
  const dim3 grid((s + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
  ball_query_kernel<<<grid, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<int*>(out), s, n, nsample, radius_sq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
