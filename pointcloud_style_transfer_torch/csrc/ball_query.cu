// Ball query: the nsample lowest-index points within a radius of each center.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/distance_topk.py::
// _ballquery_kernel (wrappers _ballquery_single / pallas_ball_query).
// Semantics kept bit for bit:
//   * a point is inside when (dx*dx + dy*dy) + dz*dz <= radius_sq, rounded op
//     by op (__f*_rn: no FMA contraction), radius_sq being float32(r*r); a
//     NaN distance is never inside;
//   * the output row holds the in-radius indices in ascending order, then the
//     empty slots take the row's first index; a row with no point inside
//     stays at the sentinel n (the caller's gather clamps it).
//
// What bounds it on the card: latency. The encoder's calls are 512 x 30,000
// (r 0.2, ns 32) and 128 x 512 (r 0.4, ns 64): a few hundred independent
// scans, far too few to fill the card's bandwidth or ALUs, and a call lasts
// as long as its longest scan: a center with fewer than ns points inside
// reads the whole cloud. One warp per center (the first design) walked such
// a row in ~940 dependent steps of 32 points, each waiting on its loads.
//
// Design: one block of kWarps warps serves one center and takes the points
// in ascending rounds of kRound = kWarps * 32 * kUnroll. In a round, warp w
// takes the w-th contiguous run of 32 * kUnroll points and issues all its
// loads before its first ballot, so kWarps * kUnroll loads are in flight
// instead of one. Each warp counts its hits with __ballot_sync / __popc; an
// exclusive prefix of the warps' counts in shared memory (warp order is
// index order) gives every hit its slot, count + warp prefix + lane prefix,
// written while it is below nsample. The hit of slot 0 is the row's first.
// The block stops after the first round that fills nsample slots, so the
// longest row is n / kRound rounds. kWarps and kUnroll are constants of the
// source, chosen with tools/sweep_kernel_plans.py ([ball_query sweep]), which
// rebuilds it with -DPCST_BQ_WARPS=w -DPCST_BQ_UNROLL=u.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PCST_BQ_WARPS
#define PCST_BQ_WARPS 16
#endif
#ifndef PCST_BQ_UNROLL
#define PCST_BQ_UNROLL 4
#endif

namespace {

constexpr int kWarps = PCST_BQ_WARPS;    // warps per block (one center)
constexpr int kUnroll = PCST_BQ_UNROLL;  // 32-point steps a warp loads at once
constexpr int kThreads = kWarps * 32;
constexpr int kSpan = 32 * kUnroll;      // points of one warp in a round
constexpr int kRound = kWarps * kSpan;   // points of the block in a round
static_assert(kWarps >= 1 && kWarps <= 32,
              "the warp prefix is one warp's scan");
static_assert(kUnroll >= 1, "a warp takes at least one step a round");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// grid (s, batch): block (c, b) serves center c of cloud b.
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ centers,
                  const float* __restrict__ points, int* __restrict__ out,
                  int s, int n, int nsample, float radius_sq) {
  __shared__ int s_hits[2][kWarps];  // per-warp hits, by round parity
  __shared__ int s_first;            // the row's lowest in-radius index
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  const float* q = centers + (static_cast<size_t>(b) * s + c) * 3;
  const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
  const float* p = points + static_cast<size_t>(b) * n * 3;
  int* o = out + (static_cast<size_t>(b) * s + c) * nsample;

  int count = 0;  // hits before this round, the same in every thread
  for (int base = 0, round = 0; base < n; base += kRound, ++round) {
    const int lo = base + warp * kSpan + lane;  // this lane's first point
    float x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = lo + u * 32;
      x[u] = y[u] = z[u] = 0.f;
      if (i < n) {
        const float* pi = p + static_cast<size_t>(i) * 3;
        x[u] = __ldg(pi);
        y[u] = __ldg(pi + 1);
        z[u] = __ldg(pi + 2);
      }
    }
    unsigned mask[kUnroll];
    int mine = 0;  // this warp's hits in the round
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool inside = lo + u * 32 < n &&
                          sq_dist(qx, qy, qz, x[u], y[u], z[u]) <= radius_sq;
      mask[u] = __ballot_sync(0xffffffffu, inside);
      mine += __popc(mask[u]);
    }
    // The parity buffers need one barrier a round: a warp writes buffer
    // round & 1 again only after the next round's barrier, which every warp
    // reaches after it has read this round's.
    int* hits = s_hits[round & 1];
    if (lane == 0) hits[warp] = mine;
    __syncthreads();
    const int h = lane < kWarps ? hits[lane] : 0;
    int incl = h;  // inclusive prefix over warps, lane l holding warp l's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int slot = count + __shfl_sync(0xffffffffu, incl - h, warp);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((mask[u] >> lane) & 1u) {
        const int pos = slot + __popc(mask[u] & below);
        const int i = lo + u * 32;
        if (pos < nsample) o[pos] = i;
        if (pos == 0) s_first = i;
      }
      slot += __popc(mask[u]);
    }
    count += total;
    if (count >= nsample) break;  // the same in every thread of the block
  }
  __syncthreads();  // s_first is written
  const int first = count > 0 ? s_first : n;  // sentinel: no point inside
  for (int j = min(count, nsample) + threadIdx.x; j < nsample; j += kThreads)
    o[j] = first;
}

}  // namespace

// centers [batch, s, 3] f32, points [batch, n, 3] f32 -> out [batch, s,
// nsample] i32, all contiguous. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int pcst_ball_query(const void* centers, const void* points,
                               void* out, int batch, int s, int n, int nsample,
                               float radius_sq, void* stream) {
  ball_query_kernel<<<dim3(s, batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<int*>(out), s, n, nsample, radius_sq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
