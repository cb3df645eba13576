// Farthest point sampling, one thread-block cluster per cloud.
//
// Replaces pointcloud_style_transfer_tpu/ops/pallas/fps.py::_fps_kernel
// (wrappers _fps_single / pallas_farthest_point_sample). Semantics kept bit
// for bit:
//   * the current index is stored before the distances are updated, starting
//     from the caller's start index;
//   * every point's running distance starts at 1e10 and takes
//     min(dist, (dx*dx + dy*dy) + dz*dz), rounded op by op (__f*_rn: no FMA
//     contraction, so the plain PyTorch version reproduces every bit);
//   * the next index is the LOWEST index reaching the maximum distance: every
//     reduction compares (value, index) pairs and keeps the smaller index on
//     equal values (float atomics could not give that).
//
// What bounds it on the card: latency. npoint iterations depend on each other
// (512 for the encoder's 30k -> 512 call), each an update of every point's
// distance and an argmax over the cloud. The TPU kernel keeps the cloud and
// its distances resident in VMEM; here the registers of a cluster of S blocks
// hold them: rank r owns the r-th contiguous slice of the cloud, and each
// thread keeps PER points' coordinates and running distances in registers,
// loaded once, so nothing is read from memory inside the loop. An iteration:
//   * every thread min-updates its points against the current centre and
//     takes its own argmax (slots ascend in index, strict '>');
//   * a warp butterfly, then warp 0 over the warps' winners, give the rank's
//     winner; its coordinates come along from the owning lane;
//   * warp 0 writes (value, index, x, y, z) into slot it & 1 of the rank's
//     shared memory, and one cluster barrier (release / acquire) publishes
//     it;
//   * in every warp of the cluster, lane r reads rank r's slot through
//     distributed shared memory and a butterfly over the S lanes reduces
//     them by the same rule, so all ranks reach the same winner and its
//     coordinates, the next centre, without a broadcast.
// Two slots suffice: a rank writes slot it & 1 again at iteration it + 2
// only after barrier it + 1, which every rank reaches after its reads of
// iteration it. A last barrier keeps every rank alive while it is read.
// Clouds larger than a cluster's registers hold (8 x 1024 x 8 = 65,536
// points) take fps_stream_kernel: the same slices, iteration and reductions,
// but each point's running distance lives in a global scratch array [B, n]
// (480 KB at 120,000 points, resident in L2) and its coordinates are re-read
// every iteration; each thread walks its points in ascending order, so its
// own argmax keeps the lowest index on ties as above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kInitDist = 1e10f;
constexpr int kNone = 0x7fffffff;  // the index of an empty candidate

__device__ __forceinline__ float sq_dist(float px, float py, float pz,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Keep the larger value; on equal values the lower index.
__device__ __forceinline__ bool beats(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

// A candidate: value, index, coordinates (two float4 so that a remote read
// is two vector loads).
struct alignas(16) Cand {
  float4 a;  // value, index bits, x, y
  float4 b;  // z, unused
};

__device__ __forceinline__ void warp_argmax_all(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The iteration's winner over the whole cloud, from each thread's own
// (best, best_i, bx, by, bz), its points being lo + j * blockDim.x + t:
//   * a warp butterfly, its coordinates from the lane that owns it;
//   * warp 0 over the warps' winners, written into slot it & 1 of the rank;
//   * (S > 1) one cluster barrier, then in every warp lane r < S reads rank
//     r's slot through distributed shared memory and a butterfly over the S
//     lanes reduces them by the same rule, so all ranks reach the same
//     winner and its coordinates, the next centre, without a broadcast.
__device__ __forceinline__ void cloud_argmax(
    float best, int best_i, float bx, float by, float bz, int lo, int it,
    int S, Cand* s_warp, Cand* s_slot, int& far, float& cx, float& cy,
    float& cz) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the warp's winner, its coordinates from the lane that owns it
  warp_argmax_all(best, best_i);
  int owner = (best_i - lo) & 31;  // slots are lo + j * nt + t, 32 | nt
  bx = __shfl_sync(0xffffffffu, bx, owner);
  by = __shfl_sync(0xffffffffu, by, owner);
  bz = __shfl_sync(0xffffffffu, bz, owner);
  if (lane == 0)
    s_warp[warp] = {make_float4(best, __int_as_float(best_i), bx, by),
                    make_float4(bz, 0.f, 0.f, 0.f)};
  __syncthreads();

  // the rank's winner, from the warps' winners
  if (warp == 0) {
    Cand c = {make_float4(-CUDART_INF_F, __int_as_float(kNone), 0.f, 0.f),
              make_float4(0.f, 0.f, 0.f, 0.f)};
    if (lane < nt / 32) c = s_warp[lane];
    float v = c.a.x;
    int i = __float_as_int(c.a.y);
    warp_argmax_all(v, i);
    owner = ((i - lo) & (nt - 1)) >> 5;  // the warp that owns index i
    const float x = __shfl_sync(0xffffffffu, c.a.z, owner);
    const float y = __shfl_sync(0xffffffffu, c.a.w, owner);
    const float z = __shfl_sync(0xffffffffu, c.b.x, owner);
    if (lane == 0)
      s_slot[it & 1] = {make_float4(v, __int_as_float(i), x, y),
                        make_float4(z, 0.f, 0.f, 0.f)};
  }

  // every rank's winner, reduced alike by every warp of the cluster:
  // lane r < S reads rank r's slot, a butterfly over the S lanes gives the
  // winner, and the lane that read it hands out its coordinates
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    Cand c = {make_float4(-CUDART_INF_F, __int_as_float(kNone), 0.f, 0.f),
              make_float4(0.f, 0.f, 0.f, 0.f)};
    if (lane < S) {
      const Cand* src = cluster.map_shared_rank(&s_slot[it & 1], lane);
      c.a = src->a;
      c.b.x = src->b.x;
    }
    float v = c.a.x;
    int i = __float_as_int(c.a.y);
    for (int off = S >> 1; off > 0; off >>= 1) {  // lanes [0, S) closed
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (beats(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    far = __shfl_sync(0xffffffffu, i, 0);
    owner = __ffs(__ballot_sync(0xffffffffu, lane < S &&
                                __float_as_int(c.a.y) == far)) - 1;
    cx = __shfl_sync(0xffffffffu, c.a.z, owner);
    cy = __shfl_sync(0xffffffffu, c.a.w, owner);
    cz = __shfl_sync(0xffffffffu, c.b.x, owner);
  } else {
    __syncthreads();
    const Cand c = s_slot[it & 1];
    far = __float_as_int(c.a.y);
    cx = c.a.z;
    cy = c.a.w;
    cz = c.b.x;
  }
}

// grid (S, batch), clusters of (S, 1, 1), blockDim.x a power of two. Point
// lo + j * blockDim.x + t of rank r's slice [lo, hi) lives in thread t's
// register slot j; PER * blockDim.x >= hi - lo.
template <int PER>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int n, int npoint, int S) {
  __shared__ Cand s_warp[kMaxWarps];
  __shared__ Cand s_slot[2];

  const int b = blockIdx.y;
  xyz += static_cast<size_t>(b) * n * 3;
  out += static_cast<size_t>(b) * npoint;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int chunk = (n + S - 1) / S;
  const int lo = min(n, rank * chunk);
  const int hi = min(n, lo + chunk);

  // a slot past the slice holds -inf, which min keeps and no '>' takes
  float px[PER], py[PER], pz[PER], dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = lo + j * nt + tid;
    px[j] = py[j] = pz[j] = 0.f;
    dist[j] = -CUDART_INF_F;
    if (p < hi) {
      dist[j] = kInitDist;
      px[j] = __ldg(xyz + static_cast<size_t>(p) * 3);
      py[j] = __ldg(xyz + static_cast<size_t>(p) * 3 + 1);
      pz[j] = __ldg(xyz + static_cast<size_t>(p) * 3 + 2);
    }
  }

  int far = start[b];
  float cx = __ldg(xyz + static_cast<size_t>(far) * 3);
  float cy = __ldg(xyz + static_cast<size_t>(far) * 3 + 1);
  float cz = __ldg(xyz + static_cast<size_t>(far) * 3 + 2);

  for (int it = 0; it < npoint; ++it) {
    if (rank == 0 && tid == 0) out[it] = far;

    float best = -CUDART_INF_F, bx = 0.f, by = 0.f, bz = 0.f;
    int best_j = -1;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      dist[j] = fminf(dist[j], sq_dist(px[j], py[j], pz[j], cx, cy, cz));
      if (dist[j] > best) {  // strict: the thread's lowest index wins ties
        best = dist[j];
        best_j = j;
        bx = px[j];
        by = py[j];
        bz = pz[j];
      }
    }
    const int best_i = best_j < 0 ? kNone : lo + best_j * nt + tid;
    cloud_argmax(best, best_i, bx, by, bz, lo, it, S, s_warp, s_slot, far,
                 cx, cy, cz);
  }
  if (S > 1) cg::this_cluster().sync();  // no rank exits while read
}

// As fps_kernel, for any n: point lo + j * blockDim.x + t of rank r's slice
// is thread t's j-th point, its coordinates read from xyz and its running
// distance from dist [batch, n] (global scratch, never read before it is
// written: iteration 0 starts from the initial distance) every iteration.
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_stream_kernel(const float* __restrict__ xyz,
                  const int* __restrict__ start, float* __restrict__ dist,
                  int* __restrict__ out, int n, int npoint, int S) {
  __shared__ Cand s_warp[kMaxWarps];
  __shared__ Cand s_slot[2];

  const int b = blockIdx.y;
  xyz += static_cast<size_t>(b) * n * 3;
  dist += static_cast<size_t>(b) * n;
  out += static_cast<size_t>(b) * npoint;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int chunk = (n + S - 1) / S;
  const int lo = min(n, rank * chunk);
  const int hi = min(n, lo + chunk);

  int far = start[b];
  float cx = __ldg(xyz + static_cast<size_t>(far) * 3);
  float cy = __ldg(xyz + static_cast<size_t>(far) * 3 + 1);
  float cz = __ldg(xyz + static_cast<size_t>(far) * 3 + 2);

  for (int it = 0; it < npoint; ++it) {
    if (rank == 0 && tid == 0) out[it] = far;

    float best = -CUDART_INF_F, bx = 0.f, by = 0.f, bz = 0.f;
    int best_i = kNone;
#pragma unroll 4
    for (int p = lo + tid; p < hi; p += nt) {
      const float x = __ldg(xyz + static_cast<size_t>(p) * 3);
      const float y = __ldg(xyz + static_cast<size_t>(p) * 3 + 1);
      const float z = __ldg(xyz + static_cast<size_t>(p) * 3 + 2);
      const float old = it == 0 ? kInitDist : dist[p];
      const float d = fminf(old, sq_dist(x, y, z, cx, cy, cz));
      dist[p] = d;
      if (d > best) {  // strict: the thread's lowest index wins ties
        best = d;
        best_i = p;
        bx = x;
        by = y;
        bz = z;
      }
    }
    cloud_argmax(best, best_i, bx, by, bz, lo, it, S, s_warp, s_slot, far,
                 cx, cy, cz);
  }
  if (S > 1) cg::this_cluster().sync();  // no rank exits while read
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int batch, int S, int threads,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// xyz [batch, n, 3] f32, start [batch] i32 (each in [0, n)) -> out
// [batch, npoint] i32, all contiguous. The plan: S in {1, 2, 4, 8} ranks per
// cluster, threads per block a power of two in [32, 1024], and PER in {1, 2,
// 4, 8} points per thread held in registers, with S * threads * PER >= n
// (so n <= 64 * 1024), or PER = 0: any n, the running distances in scratch
// [batch, n] f32. Returns the CUDA error code of the launch (0 on success).
extern "C" int pcst_fps(const void* xyz, const void* start, void* out,
                        void* scratch, int batch, int n, int npoint, int S,
                        int threads, int per, void* stream) {
  if ((S != 1 && S != 2 && S != 4 && S != 8) || threads < 32 ||
      threads > kMaxThreads || (threads & (threads - 1)) != 0 ||
      (per == 0 && scratch == nullptr) ||
      (per != 0 && static_cast<long long>(threads) * per < (n + S - 1) / S))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  float* d = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (per) {
#define PCST_PER(P)                                                        \
  case P:                                                                  \
    err = launch(fps_kernel<P>, batch, S, threads, s, x, st, o, n, npoint, \
                 S);                                                       \
    break;
    PCST_PER(1) PCST_PER(2) PCST_PER(4) PCST_PER(8)
#undef PCST_PER
    case 0:
      err = launch(fps_stream_kernel, batch, S, threads, s, x, st, d, o, n,
                   npoint, S);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
