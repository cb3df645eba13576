// The denoiser's residual block in one launch:
//   out = bf16(float(bf16(h @ W2^T + b2)) + float(x)),
//   h = relu(bf16(x @ W1^T + b1)),  x [R, 256], W1 [512, 256], W2 [256, 512],
// all bf16, float32 accumulation, each bias added in float32 before the
// product's one rounding, the residual rounded once: the rounding points of
// NoisePredictor's plain block (F.linear -> relu -> F.linear -> + x).
//
// Replaces no TPU kernel: pointcloud_style_transfer_tpu/models/networks.py's
// NoisePredictor leaves this block to XLA, which fuses the biases, the ReLU
// and the residual add into its dot fusions. On the card the plain block is
// two cuBLAS GEMMs and three elementwise passes, and the [R, 512] hidden
// layer crosses device memory four times; this kernel is the port's
// hand-written counterpart of XLA's fusion, and the hidden layer never
// leaves the SM.
//
// What bounds it on the card: operations, 4 * R * 256 * 512 FLOP on the bf16
// tensor cores (0.127 ms at 989 TFLOP/s for the direct path's 240,000 rows)
// against 1 KB of x and out a row (0.074 ms at 3.35 TB/s). A tile of 128
// rows also reads all 512 KB of both weights from L2 (1 GB at 240,000 rows),
// and its products read their operands from shared memory.
//
// Design (FlashAttention-3's inner loop without the softmax):
//   * a persistent grid, one block an SM, walks 128-row tiles; a block is
//     two warp groups of 64 rows each, 256 threads, so that a thread may
//     hold 255 registers (a producer warp or warp group, as
//     FlashAttention-3 has, puts 3 warps on an SM quarter and caps every
//     thread at 168: ptxas spilled the accumulator there, setmaxnreg
//     notwithstanding). Of the two warp groups, the one that releases a
//     buffer second (a count in shared memory) issues the TMA copy that
//     refills it, so that neither ever waits for the other: a first thread
//     that waited for the other warp group's releases, as a producer
//     does, held both in step and cost 14% at 240,000 rows on an H100;
//   * the x tile (64 KB, 128B-swizzled) is loaded once and serves as fc1's
//     A operand and as the residual; the output is written over it in place
//     and stored by TMA (ragged rows zero-filled on load, clipped on store);
//   * the hidden layer is walked in 8 chunks of 64 units: S = x W1_c^T by
//     wgmma (64 x 64 float32 a warp group), + b1, rounded to bf16, ReLU, in
//     registers; that register tile is the A operand of acc += h_c W2_c^T
//     (wgmma with A from registers, a 64 x 256 float32 accumulator, 128
//     registers a thread). The accumulator layout of the first product is
//     the register-A layout of the second, so no shuffle is needed;
//   * turn c of a warp group issues chunk c's first product and chunk
//     c - 1's second and waits for the first alone, so that chunk c's bias,
//     rounding and ReLU run while the tensor cores finish chunk c - 1 (two
//     register tiles of h in turn; the turns are unrolled by two, so that
//     no product is issued under a run-time condition, which ptxas would
//     serialize);
//   * W1 and W2 chunks (32 KB each) are double-buffered through TMA and
//     mbarriers: 64 + 2 x 64 = 192 KB of shared memory, so x has one buffer:
//     the next tile's x is prefetched into L2 while this one computes.
// The grid adapts to R: min(tiles, SMs) blocks, so below a wave every block
// takes one tile. Tiles of 64 rows were reasoned against, not measured: at
// 192 KB of shared memory an SM holds one block, and a wgmma takes 64 rows,
// so a 64-row tile is a block of one warp group. At 15,000 rows (118 tiles
// of 128 on 132 SMs) its 235 tiles would leave 103 SMs two in turn: the
// slowest SM would still compute 128 rows, one warp group after the other,
// and every row would read twice the weights from L2.
// A wait that has not ended after ~10 s traps instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N>
struct Int {  // a compile-time stage index handed to a lambda
  static constexpr int value = N;
};

constexpr int kD = 256;        // feature width (fc1's input, fc2's output)
constexpr int kH = 512;        // hidden width
constexpr int kChunk = 64;     // hidden units a chunk
constexpr int kChunks = kH / kChunk;
constexpr int kTileM = 128;    // rows a tile: two warp groups of 64
constexpr int kWgRows = 64;
constexpr int kStages = 2;     // weight chunks in flight
constexpr int kThreads = 256;
constexpr int kSlabCols = 64;  // bf16 columns in one 128-byte swizzled row

constexpr int kXSlab = kTileM * 128;                 // 16 KB: 64 columns of x
constexpr int kXBytes = kXSlab * (kD / kSlabCols);   // 64 KB
constexpr int kW1Slab = kChunk * 128;                // 8 KB
constexpr int kW1Bytes = kW1Slab * (kD / kSlabCols); // 32 KB
constexpr int kW2Half = (kD / 2) * 128;              // 16 KB: 128 rows of W2
constexpr int kW2Bytes = 2 * kW2Half;                // 32 KB
constexpr int kOffW1 = kXBytes;
constexpr int kOffW2 = kOffW1 + kStages * kW1Bytes;
constexpr int kOffBar = kOffW2 + kStages * kW2Bytes;
constexpr int kNumBars = 1 + 2 * kStages;      // x, W1 and W2 stages full
constexpr int kNumCounters = 1 + 2 * kStages;  // their releases
constexpr int kSmemBytes =
    kOffBar + kNumBars * 8 + kNumCounters * 4 + 1024;  // + alignment
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(kStages == 2 && kChunks % 2 == 0,
              "a tile's turns alternate the two stages");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (int polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0) start = clock64();
    if (clock64() - start > 20000000000LL) __trap();  // ~10 s: a lost copy
  }
}

// add one to a shared counter, acquire-release within the block; returns
// the old value
__device__ __forceinline__ uint32_t count_in(uint32_t* c) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "r"(smem_u32(c))
               : "memory");
  return old;
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// start bringing a box into L2, for a later tma_load
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128B-swizzled rows of 128 bytes:
// 8-row groups 1024 bytes apart (stride byte offset), leading byte offset
// unused by this layout
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the commit and wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256_rs(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 of a bias as floats
__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}



// chunk c's first product S = x W1_c^T (W1_c in stage U) and/or chunk
// c - 1's second acc += h_{c-1} W2_{c-1}^T (stage U ^ 1, h in a[U ^ 1]),
// each its own commit group; dx, dw1, dw2: descriptors of the warp group's
// x rows and of stage 0 of W1 and W2
template <int U, bool kFirst, bool kSecond>
__device__ __forceinline__ void issue_products(float (&s)[32],
                                               float (&acc)[128],
                                               const uint32_t (&a)[2][16],
                                               uint64_t dx, uint64_t dw1,
                                               uint64_t dw2, int c) {
  wgmma_fence();
  if constexpr (kFirst) {
#pragma unroll
    for (int kk = 0; kk < kD / kSlabCols; ++kk) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n64_ss(s, dx + ((kk * kXSlab + k * 32) >> 4),
                        dw1 + ((U * kW1Bytes + kk * kW1Slab + k * 32) >> 4),
                        (kk | k) != 0);
    }
    wgmma_commit();
  }
  if constexpr (kSecond) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n256_rs(acc, a[U ^ 1] + 4 * k,
                       dw2 + (((U ^ 1) * kW2Bytes + k * 32) >> 4),
                       (c - 1 | k) != 0);
    wgmma_commit();
  }
}

// + b1 (chunk c's 64 values at b1c), round to bf16, ReLU (NaN kept): h in
// a[U], the A fragments of fc2. Block j of 8 columns holds (row r_lo, cols
// 8j + 2q, +1) in s[4j], [4j + 1] and row r_lo + 8 in [4j + 2], [4j + 3];
// k-step t of fc2 takes blocks 2t, 2t + 1 as a[U][4t .. 4t + 3]
template <int U>
__device__ __forceinline__ void hidden(const float (&s)[32],
                                       uint32_t (&a)[2][16],
                                       const __nv_bfloat16* b1c, int q) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = bias_pair(b1c + j * 8 + 2 * q);
    a[U][2 * j] = bf16x2_bits(__hmax2_nan(
        __floats2bfloat162_rn(s[4 * j] + bb.x, s[4 * j + 1] + bb.y), zero));
    a[U][2 * j + 1] = bf16x2_bits(__hmax2_nan(
        __floats2bfloat162_rn(s[4 * j + 2] + bb.x, s[4 * j + 3] + bb.y),
        zero));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
denoiser_block_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __grid_constant__ CUtensorMap tm_w1,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __nv_bfloat16* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ b2, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the swizzle
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sx = smem;
  uint8_t* sw1 = smem + kOffW1;
  uint8_t* sw2 = smem + kOffW2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* x_full = bars;
  uint64_t* w1_full = bars + 1;
  uint64_t* w2_full = w1_full + kStages;
  // releases of x and of each weight stage: the second warp group to
  // release one (an odd old count) issues the copy that refills it, so
  // that neither warp group ever waits for the other
  uint32_t* x_count = reinterpret_cast<uint32_t*>(bars + kNumBars);
  uint32_t* w1_count = x_count + 1;
  uint32_t* w2_count = w1_count + kStages;

  const int iters = blockIdx.x < n_tiles
                        ? (n_tiles - 1 - int(blockIdx.x)) / gridDim.x + 1
                        : 0;
  const int n_chunks = iters * kChunks;  // the block's weight chunks, in order
  auto tile_row = [&](int it) {
    return (int(blockIdx.x) + it * int(gridDim.x)) * kTileM;
  };

  // chunk g (of the block's sequence) lives in stage g % 2 and is copied
  // there once both warp groups have released chunk g - 2; thread 0 issues
  // the first copies and the L2 prefetches
  const bool leader = threadIdx.x == 0;
  auto load_x = [&](int it) {
    mbar_expect_tx(x_full, kXBytes);
    for (int s = 0; s < kD / kSlabCols; ++s)
      tma_load(sx + s * kXSlab, &tm_x, s * kSlabCols, tile_row(it), x_full);
  };
  auto load_w1 = [&](int g) {
    const int st = g % kStages;
    mbar_expect_tx(&w1_full[st], kW1Bytes);
    for (int s = 0; s < kD / kSlabCols; ++s)
      tma_load(sw1 + st * kW1Bytes + s * kW1Slab, &tm_w1, s * kSlabCols,
               (g % kChunks) * kChunk, &w1_full[st]);
  };
  auto load_w2 = [&](int g) {
    const int st = g % kStages;
    mbar_expect_tx(&w2_full[st], kW2Bytes);
    for (int h = 0; h < 2; ++h)
      tma_load(sw2 + st * kW2Bytes + h * kW2Half, &tm_w2,
               (g % kChunks) * kChunk, h * (kD / 2), &w2_full[st]);
  };
  // this warp group has done with chunk g's W1 (W2): refill its stage with
  // chunk g + 2 if the other warp group has too
  auto release_w1 = [&](int g) {
    if ((count_in(&w1_count[g % kStages]) & 1) && g + kStages < n_chunks)
      load_w1(g + kStages);
  };
  auto release_w2 = [&](int g) {
    if ((count_in(&w2_count[g % kStages]) & 1) && g + kStages < n_chunks)
      load_w2(g + kStages);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kNumBars; ++i) mbar_init(&bars[i], 1);
    for (int i = 0; i < kNumCounters; ++i) x_count[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (leader && iters > 0) {
    load_x(0);
    for (int g = 0; g < kStages && g < n_chunks; ++g) {
      load_w1(g);
      load_w2(g);
    }
  }

  const int cw = threadIdx.x / 128;  // warp group cw: rows [64 cw, 64 cw + 64)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int q = lane % 4;
  const int r_lo = cw * kWgRows + warp * 16 + lane / 4;  // and r_lo + 8
  uint8_t* x_rows = sx + cw * kWgRows * 128;
  const uint64_t dx = smem_desc(x_rows), dw1 = smem_desc(sw1),
                 dw2 = smem_desc(sw2);
  float acc[128];
  float s_acc[32];
  uint32_t a[2][16];  // h of chunks c and c - 1
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;  // a tile's first product: scale 0
  for (int it = 0; it < iters; ++it) {
    mbar_wait(x_full, it & 1);
    const int g0 = it * kChunks;
    if (leader && it + 1 < iters) {  // the next tile's x into L2 meanwhile
      for (int s = 0; s < kD / kSlabCols; ++s)
        tma_prefetch(&tm_x, s * kSlabCols, tile_row(it + 1));
    }
    // turn c issues chunk c's first product and chunk c - 1's second and
    // waits for the first alone: chunk c's bias, rounding and ReLU run
    // while the tensor cores finish chunk c - 1
    mbar_wait(&w1_full[0], 0);
    issue_products<0, true, false>(s_acc, acc, a, dx, dw1, dw2, 0);
    wgmma_wait<0>();
    fence_regs<32>(s_acc);
    if (tid == 0) release_w1(g0);
    hidden<0>(s_acc, a, b1, q);
    auto turn = [&](auto u_const, int c) {
      constexpr int U = decltype(u_const)::value;  // c % 2
      const int g = g0 + c;
      mbar_wait(&w1_full[U], (c / kStages) & 1);
      mbar_wait(&w2_full[U ^ 1], ((c - 1) / kStages) & 1);
      issue_products<U, true, true>(s_acc, acc, a, dx, dw1, dw2, c);
      wgmma_wait<2>();  // chunk c - 2's second product is done
      if (c >= 2) {
        if (tid == 0) release_w2(g - 2);
      }
      wgmma_wait<1>();  // chunk c's first
      fence_regs<32>(s_acc);
      if (tid == 0) release_w1(g);
      hidden<U>(s_acc, a, b1 + c * kChunk, q);
    };
    for (int c = 1; c < kChunks - 1; c += 2) {
      turn(Int<1>(), c);
      turn(Int<0>(), c + 1);
    }
    turn(Int<1>(), kChunks - 1);
    mbar_wait(&w2_full[1], ((kChunks - 1) / kStages) & 1);
    issue_products<0, false, true>(s_acc, acc, a, dx, dw1, dw2, kChunks);
    const int g_end = (it + 1) * kChunks;
    wgmma_wait<0>();
    fence_regs<128>(acc);
    if (tid == 0) {
      release_w2(g_end - 2);
      release_w2(g_end - 1);
    }
    // out = bf16(bf16(acc + b2) + x), over x in place. Row r, column n of x
    // lies in slab n / 64 at byte r * 128 + ((n % 64 / 8) ^ (r % 8)) * 16 +
    // n % 8 * 2 (the 128B swizzle); a warp's 32 lanes hit 32 banks.
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const float2 bb = bias_pair(b2 + j * 8 + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            sx + (j / 8) * kXSlab + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
            q * 4);
        const float2 y = __bfloat1622float2(__floats2bfloat162_rn(
            acc[4 * j + 2 * h] + bb.x, acc[4 * j + 2 * h + 1] + bb.y));
        const float2 xv = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(y.x + xv.x, y.y + xv.y);
      }
    }
    // the writes, visible to the TMA store; the warp group's rows complete
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (tid == 0) {
      for (int s = 0; s < kD / kSlabCols; ++s)
        tma_store(&tm_out, x_rows + s * kXSlab, s * kSlabCols,
                  tile_row(it) + cw * kWgRows);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      // the second warp group whose store has read x loads the next
      if ((count_in(x_count) & 1) && it + 1 < iters) load_x(it + 1);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links against nothing but the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] bf16 matrix read or written in (box_rows x 64)
// boxes of 128B-swizzled rows
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kSlabCols), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// blocks resident at once (one an SM), per device; 0 until the first launch
int resident[64];

cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& to,
                   const CUtensorMap& t1, const CUtensorMap& t2,
                   const __nv_bfloat16* b1, const __nv_bfloat16* b2,
                   int n_tiles, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& fit = resident[dev % 64];
  if (fit == 0) {  // once a device, ahead of any graph capture
    err = cudaFuncSetAttribute(denoiser_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, denoiser_block_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = sms * per_sm;
  }
  const int grid = n_tiles < fit ? n_tiles : fit;
  denoiser_block_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tx, to, t1, t2, b1, b2, n_tiles);
  return cudaSuccess;
}

}  // namespace

// x [rows, 256], w1 [512, 256], b1 [512], w2 [256, 512], b2 [256] bf16 ->
// out [rows, 256] bf16, all contiguous, 16-byte aligned, out not
// overlapping x; rows >= 1. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pcst_denoiser_block(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int rows,
                                   void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tx, to, t1, t2;
  if (!make_map(encode, &tx, x, kD, rows, kTileM) ||
      !make_map(encode, &to, out, kD, rows, kWgRows) ||
      !make_map(encode, &t1, w1, kD, kH, kChunk) ||
      !make_map(encode, &t2, w2, kH, kD, kD / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (rows + kTileM - 1) / kTileM;
  const __nv_bfloat16* bias1 = static_cast<const __nv_bfloat16*>(b1);
  const __nv_bfloat16* bias2 = static_cast<const __nv_bfloat16*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch(tx, to, t1, t2, bias1, bias2, n_tiles, s);
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" const char* pcst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
