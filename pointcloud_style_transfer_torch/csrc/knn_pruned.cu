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
// (8 float ops each, never contracted into FMAs); the inputs are about
// 1.5 MB. The first design gave a block of 128 queries the whole row of
// its query tile's unskipped ref tiles, and tested every pair for an
// insert. The rows are uneven (0 to 13 tiles of 15 at 90,000 x 30,000 in
// the second pass), and all blocks are resident at once, so the longest
// rows set the launch's end.
//
// Design: a thread-block cluster of kS blocks (a constant of the source,
// PCST_PRUNED_S) serves 128 queries of one query tile, one thread a query,
// its top-k in registers:
//   * the clusters take the query tiles in descending order of their
//     unskipped ref tiles (ties by index), so that the longest rows start
//     first and the short ones fill the SMs at the end: blocks start in
//     about the order of their index, and in the second pass at 90,000 x
//     30,000 that order measured 19% faster than the tiles' own;
//   * each block counts its row's unskipped tiles (a uniform walk over nr
//     flags), and rank r takes those of ordinal [r*c, (r+1)*c), c =
//     ceil(n / kS), in ascending order; a rank with none still joins both
//     cluster barriers;
//   * an unskipped tile streams through shared memory as float4 in chunks
//     of PCST_PRUNED_CHUNK (1,024) refs, and the block takes the chunk's
//     bounding box from the loads (fminf / fmaxf drop a NaN ref, which is
//     never taken); a warp skips the
//     chunk when no query of it is nearer the box than its k-th distance.
//     That is exact: the box distance, rounded op by op as the distances
//     are, is at most the distance to every ref of the chunk (rounding is
//     monotone), so no ref of a skipped chunk passes the strict '<'. At
//     90,000 x 30,000 the second pass's starting state alone lets 62% of
//     its (warp, chunk) pairs go;
//   * the scan takes refs eight at a time and tries the inserts only when
//     the smallest of the eight (fminf drops a NaN) is below the k-th
//     distance, as csrc/knn_topk.cu does;
//   * rank 0 starts from (d_init, i_init), ranks 1..kS-1 from k copies of
//     (d_init[k-1], 0), so they take only d < d_init[k-1]; after a cluster
//     barrier rank 0 inserts ranks 1..kS-1's lists through distributed
//     shared memory in rank order, each in list order, with the same strict
//     '<'. That is the one scan's result: a later rank holds only later
//     arrivals, so on an equal distance its entry loses, as the scan order
//     says; an entry at or above d_init[k-1] can never enter (all k initial
//     entries are at most that and arrive first); the seed copies never pass
//     rank 0's strict '<', whose k-th is at most d_init[k-1]. A second
//     barrier keeps every rank alive while it is read.
// Above k = 16 the lists leave the registers: knn_pruned_pass_global_kernel
// copies each row's initial list into the output and keeps it there (global
// memory, hot in L1 and L2), its k-th distance in a register; a block of
// 128 queries scans its row's unskipped tiles in ascending order with the
// eight-ref filter and the same strict '<' (no cluster, no box test, the
// query tiles in their own order). An insert shifts the entries after it by
// one, which is the register version's swap network.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace cg = cooperative_groups;

#ifndef PCST_PRUNED_S
#define PCST_PRUNED_S 2
#endif
// refs staged per shared-memory chunk (16 KB), the unit of the box test
#define PCST_PRUNED_CHUNK 1024
// ints of shared scratch the longest-first order may use (a smaller value
// only serves to test its fallback to the tiles' own order)
#ifndef PCST_PRUNED_SCRATCH
#define PCST_PRUNED_SCRATCH (4 * PCST_PRUNED_CHUNK)
#endif

namespace {

constexpr int kS = PCST_PRUNED_S;  // blocks per cluster, a share of the tiles
constexpr int kThreads = 128;
constexpr int kChunk = PCST_PRUNED_CHUNK;
constexpr int kScratch = PCST_PRUNED_SCRATCH;
constexpr int kUnroll = 8;    // refs tried together before any insert
constexpr float kInf = std::numeric_limits<float>::infinity();

static_assert(kS == 1 || kS == 2 || kS == 4 || kS == 8,
              "a portable cluster size");
// 16 lists of kThreads (distance, index) pairs fit the chunk
static_assert(16 * kThreads * 8 <= kChunk * sizeof(float4), "lists > chunk");
static_assert(kScratch <= 4 * kChunk, "the order's scratch is the chunk's");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Sorted insert on strict '<' (a NaN never passes).
template <int K>
__device__ __forceinline__ void insert(float (&D)[K], int (&I)[K], float d,
                                       int idx) {
  if (d < D[K - 1]) {
    D[K - 1] = d;
    I[K - 1] = idx;
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

// The squared distance from a point to a box, in sq_dist's rounding: at most
// sq_dist to any point in the box. Infinite when the box is empty (lo > hi).
__device__ __forceinline__ float box_sq_dist(float qx, float qy, float qz,
                                             const float* box) {
  const float gx = fmaxf(fmaxf(__fsub_rn(box[0], qx), __fsub_rn(qx, box[3])),
                         0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(box[1], qy), __fsub_rn(qy, box[4])),
                         0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(box[2], qz), __fsub_rn(qz, box[5])),
                         0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// The number of unskipped ref tiles in a skip row.
__device__ __forceinline__ int unskipped(const int* __restrict__ row, int nr) {
  int n = 0;
  for (int j = 0; j < nr; ++j) n += __ldg(row + j) == 0;
  return n;
}

// The query tile of the slot-th place in descending order of unskipped ref
// tiles, ties by index (a permutation of the tiles; any one would give the
// same results), and its count of unskipped tiles. Every block computes it
// alike: the rows' counts into shared memory, their histogram, the count
// that holds the slot (from the largest down), then warp 0 finds the slot's
// ordinal among the tiles of that count with ballots. s: shared scratch of
// s_ints ints; a smaller one than nq + nr + 3 (nq + nr > 4,093 with the
// staging chunk's 4,096, about 2.1 million queries) keeps the tiles' own
// order. Only the time depends on the order, never the results; the card
// tests build the kernel with a small PCST_PRUNED_SCRATCH to run that
// fallback (tests/test_torch_kernels_cuda.py).
__device__ int tile_of_slot(const int* __restrict__ skip, int nq, int nr,
                            int slot, int* s, int s_ints, int& n_tiles) {
  if (nq + nr + 3 > s_ints) {
    n_tiles = unskipped(skip + static_cast<size_t>(slot) * nr, nr);
    return slot;
  }
  int* counts = s;            // [nq]: unskipped tiles of each query tile
  int* hist = s + nq;         // [0, nr]: query tiles by that count
  int* pick = hist + nr + 1;  // the count that holds the slot, its ordinal
  for (int i = threadIdx.x; i < nq; i += kThreads)
    counts[i] = unskipped(skip + static_cast<size_t>(i) * nr, nr);
  for (int c = threadIdx.x; c <= nr; c += kThreads) hist[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nq; i += kThreads) atomicAdd(&hist[counts[i]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      int before = 0, c = nr;  // the counts sum to nq > slot
      while (before + hist[c] <= slot) before += hist[c--];
      pick[0] = c;
      pick[1] = slot - before;
    }
    __syncwarp();
    const int count = pick[0];
    int left = pick[1];  // tiles of that count to pass, in index order
    for (int base = 0;; base += 32) {  // the warp's values are uniform
      const int i = base + static_cast<int>(threadIdx.x);
      unsigned hits = __ballot_sync(~0u, i < nq && counts[i] == count);
      const int n = __popc(hits);
      if (left < n) {
        for (; left > 0; --left) hits &= hits - 1;
        if (threadIdx.x == 0) pick[1] = base + __ffs(hits) - 1;
        break;
      }
      left -= n;
    }
  }
  __syncthreads();
  const int tile = pick[1];
  n_tiles = counts[tile];
  __syncthreads();  // the scratch is free again
  return tile;
}

// grid (query tiles * blocks a tile * kS), clusters of (kS, 1, 1); the
// clusters of slot g / blocks a tile serve rows (g % blocks a tile) *
// kThreads + t of its query tile (tile_of_slot), t < kThreads, those below
// tq. (One block per SM at least, as knn_topk_kernel: more registers.)
template <int K>
__global__ void __cluster_dims__(kS, 1, 1) __launch_bounds__(kThreads, 1)
knn_pruned_pass_kernel(const float* __restrict__ query,
                       const float* __restrict__ ref,
                       const int* __restrict__ skip,
                       const float* __restrict__ d_init,
                       const int* __restrict__ i_init,
                       float* __restrict__ d_out, int* __restrict__ i_out,
                       int nq, int tq, int tr, int nr) {
  // a chunk of refs, then (kS > 1) the rank's lists: list t of query l at
  // s_d[t * kThreads + l], s_i likewise
  __shared__ float4 smem[kChunk];
  __shared__ float s_box[kThreads / 32][6];  // each warp's share of a box
  const int rank = blockIdx.x % kS;  // the block's rank in its cluster
  const int g = blockIdx.x / kS;
  const int per_tile = (tq + kThreads - 1) / kThreads;
  int n_tiles;  // the query tile's unskipped ref tiles
  const int qi = tile_of_slot(skip, nq, nr, g / per_tile,  // the query tile
                              reinterpret_cast<int*>(smem), kScratch, n_tiles);
  const int within = (g % per_tile) * kThreads + threadIdx.x;
  const bool active = within < tq;
  const size_t row = static_cast<size_t>(qi) * tq + within;
  const int* skip_row = skip + static_cast<size_t>(qi) * nr;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  float D[K];
  int I[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    D[t] = 0.f;  // an inactive thread takes nothing
    I[t] = 0;
  }
  if (active) {
    qx = query[row * 3 + 0];
    qy = query[row * 3 + 1];
    qz = query[row * 3 + 2];
    const float seed = d_init[row * K + K - 1];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      D[t] = rank == 0 ? d_init[row * K + t] : seed;
      I[t] = rank == 0 ? i_init[row * K + t] : 0;
    }
  }

  // this rank's share of the row's unskipped tiles, by ordinal
  const int per_rank = (n_tiles + kS - 1) / kS;
  const int first = rank * per_rank;
  const int last = min(n_tiles, first + per_rank);
  int ordinal = 0;
  for (int j = 0; j < nr && ordinal < last; ++j) {
    if (__ldg(skip_row + j) != 0) continue;
    if (ordinal++ < first) continue;
    for (int off = 0; off < tr; off += kChunk) {
      const int base = j * tr + off;
      const int n = min(kChunk, tr - off);
      __syncthreads();  // the previous chunk and box are no longer read
      float box[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const float* p = ref + static_cast<size_t>(base + c) * 3;
        const float4 v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
        smem[c] = v;
        box[0] = fminf(box[0], v.x);
        box[1] = fminf(box[1], v.y);
        box[2] = fminf(box[2], v.z);
        box[3] = fmaxf(box[3], v.x);
        box[4] = fmaxf(box[4], v.y);
        box[5] = fmaxf(box[5], v.z);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          box[a] = fminf(box[a], __shfl_xor_sync(~0u, box[a], o));
          box[a + 3] = fmaxf(box[a + 3], __shfl_xor_sync(~0u, box[a + 3], o));
        }
      }
      if (threadIdx.x % 32 == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) s_box[threadIdx.x / 32][a] = box[a];
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          box[a] = fminf(box[a], s_box[w][a]);
          box[a + 3] = fmaxf(box[a + 3], s_box[w][a + 3]);
        }
      }
      // a NaN query or an inactive thread (k-th 0) takes nothing: it votes
      // to skip
      if (__all_sync(~0u, !(box_sq_dist(qx, qy, qz, box) < D[K - 1])))
        continue;
      int c = 0;
      for (; c + kUnroll <= n; c += kUnroll) {
        float4 r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r[u] = smem[c + u];
        float d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          d[u] = sq_dist(qx, qy, qz, r[u].x, r[u].y, r[u].z);
        // fminf drops a NaN; the inserts below refuse it on their own
        float lowest = d[0];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) lowest = fminf(lowest, d[u]);
        if (lowest < D[K - 1]) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) insert<K>(D, I, d[u], base + c + u);
        }
      }
      for (; c < n; ++c) {
        const float4 r = smem[c];
        insert<K>(D, I, sq_dist(qx, qy, qz, r.x, r.y, r.z), base + c);
      }
    }
  }

  if constexpr (kS > 1) {
    float* s_d = reinterpret_cast<float*>(smem);
    int* s_i = reinterpret_cast<int*>(s_d + K * kThreads);
    __syncthreads();  // the last chunk is no longer read
    if (rank != 0) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        s_d[t * kThreads + threadIdx.x] = D[t];
        s_i[t * kThreads + threadIdx.x] = I[t];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // release the lists, acquire the other ranks'
    if (rank == 0) {
      for (int src = 1; src < kS; ++src) {
        const float* rd = cluster.map_shared_rank(s_d, src);
        const int* ri = cluster.map_shared_rank(s_i, src);
#pragma unroll
        for (int t = 0; t < K; ++t)
          insert<K>(D, I, rd[t * kThreads + threadIdx.x],
                    ri[t * kThreads + threadIdx.x]);
      }
    }
    cluster.sync();  // no rank exits while its lists are read
    if (rank != 0) return;
  }

  if (active) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d_out[row * K + t] = D[t];
      i_out[row * K + t] = I[t];
    }
  }
}

// The sorted insert of (d, idx) into a global list of k entries, after
// every entry it does not beat (strict '<'); returns the new k-th distance.
__device__ __forceinline__ float insert_global(float* D, int* I, int k,
                                               float d, int idx) {
  int t = k - 1;
  while (t > 0 && d < D[t - 1]) {
    D[t] = D[t - 1];
    I[t] = I[t - 1];
    --t;
  }
  D[t] = d;
  I[t] = idx;
  return D[k - 1];
}

// grid (query tiles * blocks a tile), no cluster; any k >= 1. Block g serves
// rows (g % blocks a tile) * kThreads + t of query tile g / blocks a tile,
// those below tq, each list at d_out/i_out [row, :].
__global__ void __launch_bounds__(kThreads)
knn_pruned_pass_global_kernel(const float* __restrict__ query,
                              const float* __restrict__ ref,
                              const int* __restrict__ skip,
                              const float* __restrict__ d_init,
                              const int* __restrict__ i_init,
                              float* __restrict__ d_out,
                              int* __restrict__ i_out, int tq, int tr, int nr,
                              int k) {
  __shared__ float4 smem[kChunk];
  const int per_tile = (tq + kThreads - 1) / kThreads;
  const int qi = blockIdx.x / per_tile;  // the query tile
  const int within = (blockIdx.x % per_tile) * kThreads + threadIdx.x;
  const bool active = within < tq;
  const size_t row = static_cast<size_t>(qi) * tq + within;
  const int* skip_row = skip + static_cast<size_t>(qi) * nr;
  float* D = d_out + row * k;
  int* I = i_out + row * k;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  float kth = 0.f;
  if (active) {
    qx = query[row * 3 + 0];
    qy = query[row * 3 + 1];
    qz = query[row * 3 + 2];
    for (int t = 0; t < k; ++t) {
      D[t] = d_init[row * k + t];
      I[t] = i_init[row * k + t];
    }
    kth = D[k - 1];
  }
  for (int j = 0; j < nr; ++j) {
    if (__ldg(skip_row + j) != 0) continue;  // the same for the whole block
    for (int off = 0; off < tr; off += kChunk) {
      const int base = j * tr + off;
      const int n = min(kChunk, tr - off);
      __syncthreads();  // the previous chunk is no longer read
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const float* p = ref + static_cast<size_t>(base + c) * 3;
        smem[c] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
      }
      __syncthreads();
      if (!active) continue;
      int c = 0;
      for (; c + kUnroll <= n; c += kUnroll) {
        float d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 r = smem[c + u];
          d[u] = sq_dist(qx, qy, qz, r.x, r.y, r.z);
        }
        float lowest = d[0];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) lowest = fminf(lowest, d[u]);
        if (lowest < kth) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (d[u] < kth) kth = insert_global(D, I, k, d[u], base + c + u);
        }
      }
      for (; c < n; ++c) {
        const float4 r = smem[c];
        const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
        if (d < kth) kth = insert_global(D, I, k, d, base + c);
      }
    }
  }
}

template <int K>
void launch(const float* q, const float* r, const int* skip, const float* d0,
            const int* i0, float* d, int* i, int nq, int nr, int tq, int tr,
            cudaStream_t stream) {
  const dim3 grid(nq * ((tq + kThreads - 1) / kThreads) * kS);
  knn_pruned_pass_kernel<K><<<grid, kThreads, 0, stream>>>(
      q, r, skip, d0, i0, d, i, nq, tq, tr, nr);
}

}  // namespace

// query [nq * tq, 3] f32 and ref [nr * tr, 3] f32 (Morton-sorted, padded to
// whole tiles), skip [nq * nr] i32, d_init/i_init [nq * tq, k] ->
// d_out/i_out [nq * tq, k], all contiguous; d_out/i_out may not alias the
// inputs. k >= 1: clusters of PCST_PRUNED_S for k <= 16, the global-list
// kernel above. Returns the CUDA error code of the launch.
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
  if (nq < 1 || nr < 1 || tq < 1 || tr < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k > 16) {
    knn_pruned_pass_global_kernel<<<nq * ((tq + kThreads - 1) / kThreads),
                                    kThreads, 0, s>>>(q, r, sk, d0, i0, d, i,
                                                      tq, tr, nr, k);
    return static_cast<int>(cudaGetLastError());
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
