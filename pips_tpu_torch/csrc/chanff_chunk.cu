// F-chunked MLP-Mixer channel block, bf16:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the two TPU kernels of tools/profile_chanff_chunk.py's
// make_chunked: its forward (pallas_call at :121 of _fwd_kernel_chunked) and
// its backward (:149, _bwd_kernel_chunked). They compute the channel block of
// chanff_fwd.cu and chanff_bwd.cu with F walked in static chunks of fc
// columns, the chunk's pre-activation kept on chip (VMEM) between its two
// matmuls and never written to HBM. The tool times a 12-block chain of them
// at R=1024, D=512, F=2048 against the monolithic kernels.
//
// What bounds it on an H100: as for the monolithic kernels, 4*R*D*F
// operations forward and 10*R*D*F backward at the bf16 tensor-core rate (at
// R=1024: 4.3 us and 10.9 us at 989 TFLOP/s), against a few MB of rows and
// weights. Kept on chip, the activation costs no bytes; but each row tile
// walks both weights (4 MB) from L2, and its accumulators must fit in
// registers, which keeps row tiles to 64 rows. On the card the copies do
// not bound it (without them a call is ~6% faster, profile_pipelines): the
// products and the GELU epilogues do, about equally, so the design overlaps
// them.
//
// Design: one fused chunk pipeline a call, on wgmma behind a TMA ring.
//   * A block owns a row tile of kRowTile = 64 rows (one wgmma M) and a run
//     of F columns: the host's plan (chanff_chunk_cuda.chunk_plan) cuts F
//     into `split` equal runs of whole chunks, the blocks of a row tile one
//     thread-block cluster along x, run r taking F columns [r*run, (r+1)*run)
//     in chunk order. Where one row tile's blocks are all there is (small R)
//     the split fills the card; at large R, split 1.
//   * Two consumer warpgroups split the 512 output columns, 256 each, so the
//     64 x 512 f32 accumulator of y (forward) or dxa (backward) is 128
//     registers a thread, held across the whole run; setmaxnreg gives the
//     consumers 240 registers and the producer warpgroup 24. One thread of
//     the producer warpgroup keeps a ring of weight tiles full by TMA
//     (128-byte swizzled boxes, complete_tx mbarriers); the other three
//     producer warps only meet the cluster barriers.
//   * The LN runs in the prologue, a consumer warp a row, into a resident xa
//     tile (64 x 512 bf16, eight K-major 64-column boxes written in TMA's
//     swizzle) while the producer's first loads are in flight.
//   * F is walked in slabs (forward kFwdSlab = 256 columns, backward
//     kBwdSlab = 128: the backward holds a1 and dg1 beside dxa). The slab is
//     a unit of the pipeline, not of the sums: a rank's y (dxa) accumulates
//     over its whole run in registers, and the chunk width fc only cuts F
//     into the runs, so the rank-order sum below is the reference's chunk
//     order.
//   forward (chanff_chunk_fwd), per slab j: a1 = xa @ w1[:, slab] (each
//     warpgroup 128 of its columns, m64n128k16, K = 512); + b1, GELU, one
//     bf16 rounding into a 64 x 256 g1 slab in shared memory, written in
//     wgmma's K-major swizzle (g1 never reaches device memory: the plan
//     allocates no scratch); y += g1_slab @ w2[slab, :] (two m64n128k16 a
//     warpgroup). The slabs are double-buffered so that the activation
//     product of slab j + 1 is issued ahead of the out product of slab j,
//     and the GELU of slab j + 1 runs on the CUDA cores, two n8 tiles after
//     each out step, while the tensor cores run that step
//     (wgmma_wait<1>: every group but the newest has completed).
//   backward (chanff_chunk_bwd_rows), per slab j: a1 = xa @ w1[:, slab] and
//     dg1 = dy @ w2[slab, :]^T (each warpgroup 64 of the slab's columns,
//     m64n64k16, K = 512, dy's 64-column boxes streamed beside the weights);
//     the epilogue forms g1 = gelu(a) and da1 = dg1 * gelu'(a) (a = a1 + b1,
//     f32), writes g1_c and da1_c to the scratch pips_chanff_bwd_finish
//     reads, da1_c also into a K-major slab, and the tile's column sums of
//     the f32 da1 (the db1 partials); dxa += da1_slab @ w1[:, slab]^T (w1
//     K-major, 256 rows of D a warpgroup, two m64n128k16). The epilogue of
//     slab j + 1 runs, two n8 tiles after each dxa step, while the tensor
//     cores run slab j's dxa products.
//   * At the end the blocks of a cluster stage their partial 64 x 512 f32
//     tiles (XOR-swizzled rows) over xa and the slabs and add them in rank
//     order through distributed shared memory, block r taking columns
//     [512 r / split, 512 (r + 1) / split), loads in rounds issued before
//     any is used: deterministic, no atomics. (Pushing each partial to its
//     owner by remote stores instead was slower.) The
//     forward then writes y = (x + o) + b2, rounded once. The backward runs
//     the LN backward on its columns (the row means over 512 columns summed
//     over the cluster in rank order, as chanff_bwd.cu's dxa epilogue does)
//     and writes dx, and the part_d partials (LN scale, LN bias, b2) of its
//     columns for the row tile; chanff_bwd.cu's weight-grad products and
//     ordered column sums (pips_chanff_bwd_finish, told kRowTile-row
//     partial tiles) finish the grads.
// Shared memory (1024-aligned): forward: xa 64 KB, two g1 slabs of 32 KB,
// a ring of kFwdStages = 3 slots of 32 KB (an activation step: w1's 64 x 256
// box of k x F; an out step: w2's 32 x 512 box), the next slab's b1; 226 KB
// in all. Backward: xa 64 KB, two da1 slabs of 16 KB, a ring of kBwdStages
// = 3 slots of 40 KB (an activation step: w1's 64 x 128 box, w2's 128 x 64
// and dy's 64 x 64, both K-major; a dxa step: w1's K-major 256 x 64 box for
// one warpgroup, the other only waits and releases it), the row statistics,
// the column partials' staging and the next slab's b1; 222 KB. The tail's
// staged tiles and scratch reuse xa, the slabs and the ring's slots.
// chanff_tiles.cuh's Ring arms every stage for one fixed size, so this file
// has its own (Pipe: a byte count a step).
//
// Numerics follow the JAX chunked kernels (chan_ff_chunked_reference and its
// backward): LN in f32 (var = E[x^2] - mu^2 clamped at 0, eps 1e-5); the fc1
// and fc2 products of bf16 operands accumulate in f32 and take the f32 bias
// unrounded; o and dxa accumulate in f32, chunk after chunk; y is rounded
// once. GELU's erf is XLA's rational erf, as in the TPU kernels (phi below).
//
// Plain C ABI (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; 0 means launched.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "async_copy.cuh"
#include "chanff_rows.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 512;  // channel width the kernels are built for
using bf16 = __nv_bfloat16;

constexpr int kRowTile = 64;                 // rows of a block: one wgmma M, the partials' tiles
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = 384;                // and the producer warpgroup
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kConsumerRegs = 240;           // setmaxnreg: 256 * 240 + 128 * 24 = 384 * 168
constexpr int kProducerRegs = 24;
constexpr int kMaxSplit = 8;                 // blocks of a cluster at most (the portable size)
constexpr int kFwdSlab = 256;                // F columns of a forward slab
constexpr int kBwdSlab = 128;                // F columns of a backward slab
constexpr int kFwdStages = 3;
constexpr int kFwdSlot = 32768;
constexpr int kBwdStages = 3;
constexpr int kBwdSlot = 40960;
constexpr int kBox = 64 * 64 * 2;            // 8,192: 64 rows of 64 bf16, 128-byte swizzled
constexpr int kTileBytes = kRowTile * kD * 2;  // 65,536: xa, eight K-major boxes
constexpr int kAlign = 1024;                 // the swizzle's period: boxes start on it
constexpr int kRound = 8;                    // loads an epilogue thread issues before using one

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned char* align_up(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + kAlign - 1) &
                                          ~uintptr_t(kAlign - 1));
}

// mbarrier operations on 32-bit shared addresses (async_copy.cuh's take
// generic pointers, 64-bit registers the consumers cannot spare)
__device__ __forceinline__ uint32_t bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// the box at (c0, c1) of `map` into shared address dst, completing on bar
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A ring of kStages slots of kSlot bytes, full and empty mbarriers each, on
// 32-bit shared addresses; step i goes through slot i % kStages and is armed
// for its own byte count. Every consumer warp releases every step (a
// warpgroup that does not use a step waits for it and releases it at once).
// The producer's waits keep mbar_wait's watchdog (a copy that never lands
// stalls the producer too, which then traps and ends the launch); the
// consumers' have none: a __trap anywhere in their unrolled loops cost them
// hundreds of bytes of spills (ptxas -v).
template <int kStages, int kSlot>
struct Pipe {
  static constexpr int kSmem = kStages * kSlot + 2 * kStages * 8;
  uint32_t tiles;  // the slots; the full barriers, then the empty ones, follow them

  __device__ explicit Pipe(unsigned char* base) : tiles(smem_u32(base)) {}
  __device__ uint32_t full(int s) const { return tiles + kStages * kSlot + 8 * s; }
  __device__ uint32_t empty(int s) const { return full(kStages + s); }
  // one thread, then a block barrier
  __device__ void init(unsigned char* base) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + kStages * kSlot);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[kStages + s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  // producer: step i's slot once its last use is released, armed for `bytes`
  __device__ uint32_t acquire(int i, uint32_t bytes, unsigned char* base) {
    const int s = i % kStages;
    if (i >= kStages)
      mbar_wait(reinterpret_cast<uint64_t*>(base + kStages * kSlot) + kStages + s,
                ((i / kStages) - 1) & 1);
    bar_arrive_tx(full(s), bytes);
    return tiles + s * kSlot;
  }
  __device__ uint32_t bar(int i) const { return full(i % kStages); }
  // consumer: step i's slot once its tiles have landed
  __device__ uint32_t wait(int i) const {
    while (!bar_try(full(i % kStages), (i / kStages) & 1)) {
    }
    return tiles + (i % kStages) * kSlot;
  }
  __device__ void release(int i) const {
    if (threadIdx.x % 32 == 0) bar_arrive(empty(i % kStages));
  }
};

// gmma_desc (128-byte swizzle) of the shared-memory address a; a descriptor
// plus (bytes >> 4) is that of a + bytes, so each k16 step of a tile is one
// add to its tile's descriptor
__device__ __forceinline__ uint64_t desc128(uint32_t a, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// a K-major tile (rows of 128 bytes, 8-row groups 1024 apart), and an
// MN-major one (rows along K; 64-column groups `group` bytes apart)
__device__ __forceinline__ uint64_t kdesc(uint32_t a) { return desc128(a, 16, 1024); }
__device__ __forceinline__ uint64_t mndesc(uint32_t a, uint32_t group) {
  return desc128(a, group, 1024);
}
// the k16 step at column k of a 64-row K-major operand in 64-column boxes
// kBox apart (xa, a g1 or da1 slab), from the descriptor of its first box
__device__ __forceinline__ uint64_t kstep(uint64_t boxes, int k) {
  return boxes + (((k / 64) * kBox + (k % 64) * 2) >> 4);
}

__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// byte offset of column c (of 64) in row r of a 128-byte-swizzled box
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// The standard normal CDF by XLA's rational erf (ErfImpl32, the TPU kernels'
// erf: x P(x^2) / Q(x^2) with x clamped to [-4, 4]): branch-free and about
// half the instructions of CUDA's erff, within 4.2e-7 (7 f32 ulps) of erf.
__device__ __forceinline__ float phi(float a) {
  const float x = fminf(fmaxf(a * 0.70710678118654752f, -4.0f), 4.0f), x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = fmaf(p, x2, 2.77068142495902e-08f);
  p = fmaf(p, x2, -2.10102402082508e-06f);
  p = fmaf(p, x2, -5.69250639462346e-05f);
  p = fmaf(p, x2, -7.34990630326855e-04f);
  p = fmaf(p, x2, -2.95459980854025e-03f);
  p = fmaf(p, x2, -1.60960333262415e-02f);
  float q = -1.45660718464996e-05f;
  q = fmaf(q, x2, -2.13374055278905e-04f);
  q = fmaf(q, x2, -1.68282697438203e-03f);
  q = fmaf(q, x2, -7.37332916720468e-03f);
  q = fmaf(q, x2, -1.42647390514189e-02f);
  return fmaf(0.5f, __fdividef(x * p, q), 0.5f);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void zero(float* acc, int n) {
#pragma unroll
  for (int j = 0; j < n; ++j) acc[j] = 0.0f;
}

// The row tile's LayerNorm, a consumer warp a row: xa (eight K-major boxes)
// = LN(x) * scale + bias in bf16, zero past R; with stats, (mu, rsig) of row
// r at stats[r]; with xa_out, the rounded values of columns [c0, c1) also to
// device memory. A warp's eight rows are loaded before the first is used
// (one round trip to memory, not eight).
__device__ void ln_tile(const bf16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, unsigned char* xa, int row0, int R,
                        float2* stats, bf16* __restrict__ xa_out, int c0, int c1) {
  constexpr int kRows = kRowTile / (kConsumers / 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4 raw[kRows][2];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int row = row0 + warp + kRows * m;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      raw[m][h] = row < R
                      ? *reinterpret_cast<const uint4*>(x + (size_t)row * kD + 256 * h + 8 * lane)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int r = warp + kRows * m, row = row0 + r;
    float v[16];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w[4] = {raw[m][h].x, raw[m][h].y, raw[m][h].z, raw[m][h].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 b2;
        memcpy(&b2, &w[q], 4);
        const float2 f = __bfloat1622float2(b2);
        v[8 * h + 2 * q] = f.x;
        v[8 * h + 2 * q + 1] = f.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s += v[j];
      s2 += v[j] * v[j];
    }
    float mu, rsig;
    warp_ln_stats<kD>(s, s2, mu, rsig);
    if (stats != nullptr && lane == 0) stats[r] = make_float2(mu, rsig);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 256 * h + 8 * lane;
      const float4 sa = *reinterpret_cast<const float4*>(scale + c);
      const float4 sb = *reinterpret_cast<const float4*>(scale + c + 4);
      const float4 ba = *reinterpret_cast<const float4*>(bias + c);
      const float4 bb = *reinterpret_cast<const float4*>(bias + c + 4);
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = row < R ? pack2((v[8 * h + 2 * q] - mu) * rsig * sc[2 * q] + bi[2 * q],
                               (v[8 * h + 2 * q + 1] - mu) * rsig * sc[2 * q + 1] + bi[2 * q + 1])
                       : 0u;
      const uint4 out = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(xa + (c / 64) * kBox + swz(r, c % 64)) = out;
      if (xa_out != nullptr && row < R && c >= c0 && c < c1)
        *reinterpret_cast<uint4*>(xa_out + (size_t)row * kD + c) = out;
    }
  }
}

// float index of (row r, column c) in a staged 64 x 512 f32 tile: 8-float
// groups XOR-swizzled by the row, so a fragment's rows fall on other banks
__device__ __forceinline__ int stg(int r, int c) { return r * kD + (c ^ ((r & 7) << 3)); }

// a warpgroup's 64 x 128 accumulator (wgmma's fragments: value 4 n + 2 hi + e
// at row 16 warp + lane / 4 + 8 hi, column 8 n + 2 (lane % 4) + e) into the
// staged tile at columns c0 ..
__device__ __forceinline__ void stage_acc(float* tile, const float* acc, int c0) {
  const int wl = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = 16 * wl + lane / 4 + 8 * hi, c = c0 + 8 * n + 2 * (lane % 4);
      *reinterpret_cast<float2*>(tile + stg(r, c)) =
          make_float2(acc[4 * n + 2 * hi], acc[4 * n + 2 * hi + 1]);
    }
}

// the staged tiles of the blocks of the cluster, in rank order (the ranks
// past `split` repeat rank 0; indexed by constants only, kept in registers)
__device__ __forceinline__ void cluster_tiles(const float* (&part)[kMaxSplit], float* tile,
                                              int split, cg::cluster_group& cluster) {
#pragma unroll
  for (int k = 0; k < kMaxSplit; ++k) part[k] = cluster.map_shared_rank(tile, k < split ? k : 0);
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int split, int row_tiles, int smem, cudaStream_t s,
                           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, row_tiles, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// clusters of `split` blocks of `kernel` that the card holds at once
template <typename Kernel>
int max_clusters(Kernel kernel, int split, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// ------------------------------------------------------------------ forward
namespace fwd {
constexpr int kSlab = kFwdSlab;
constexpr int kHalf = kSlab / 2;               // 128: a warpgroup's a1 columns
constexpr int kAK = kFwdSlot / (kSlab * 2);    // 64: xa columns (K) of an activation step
constexpr int kASteps = kD / kAK;              // 8
constexpr int kOK = kFwdSlot / (kD * 2);       // 32: slab columns (K) of an out step
constexpr int kOSteps = kSlab / kOK;           // 8
constexpr int kOBox = kOK * 128;               // 4,096: w2's 32 x 64 box
constexpr int kSlabBytes = kRowTile * kSlab * 2;  // 32,768: a g1 slab, four K-major boxes
constexpr int kPiece = kHalf / 8 / kOSteps;    // a1's n8 tiles GELU'd after each out step
using Ring = Pipe<kFwdStages, kFwdSlot>;
constexpr int kSmem = kAlign + kTileBytes + 2 * kSlabBytes + Ring::kSmem + kSlab * 4;
static_assert(kAK * 128 == kBox, "an activation step is kSlab / 64 boxes of w1");
static_assert(kPiece * kOSteps * 8 == kHalf, "the GELU pieces cover a warpgroup's a1");
static_assert(kTileBytes + 2 * kSlabBytes == kRowTile * kD * 4,
              "y is staged over xa and the slabs");
static_assert(kSmem <= 232448, "the forward must fit a block's shared memory");
static_assert(kSlab == kConsumers, "a consumer thread stages one column's b1");

// a1 += xa[:, 64 s ..] @ one activation step's w1 box (64 x 256: boxes of
// 64 columns of F, warpgroup wg's two of them); xa: its first box's descriptor
__device__ __forceinline__ void act_step(float* a1, uint64_t xa, uint32_t st, int s, int wg) {
  const uint64_t b = mndesc(st + 2 * wg * kBox, kBox);
#pragma unroll
  for (int kk = 0; kk < kAK / 16; ++kk)
    wgmma_m64n128k16<0, 1>(a1, kstep(xa, s * kAK + 16 * kk), b + kk * (2048 >> 4));
}

// y += g1_slab[:, 32 t ..] @ one out step's w2 box (32 x 512: boxes of 64
// columns, warpgroup wg's four of them, 128 columns into y0 and 128 into y1)
__device__ __forceinline__ void out_step(float* y0, float* y1, uint64_t g1, uint32_t st, int t,
                                         int wg) {
  const uint64_t b = mndesc(st + 4 * wg * kOBox, kOBox);
#pragma unroll
  for (int kk = 0; kk < kOK / 16; ++kk) {
    const uint64_t a = kstep(g1, t * kOK + 16 * kk);
    wgmma_m64n128k16<0, 1>(y0, a, b + kk * (2048 >> 4));
    wgmma_m64n128k16<0, 1>(y1, a, b + ((2 * kOBox + kk * 2048) >> 4));
  }
}

// GELU of a1's n8 tiles [n0, n0 + kPiece): g1 = gelu(a1 + b1) rounded once
// into the slab at shared address g1 (columns 128 wg + 8 n ..); b1: the
// slab's bias in shared memory, F column f of slab column 0; columns at or
// past f_end (a run that ends inside the slab) hold zeros. The thread's rows
// are 16 warp + lane / 4 (+ 8), so the swizzle's row term is lane / 4 for both.
__device__ __forceinline__ void gelu_piece(const float* a1, int n0, const float* b1, int f,
                                           int f_end, uint32_t g1, int wg) {
  const int wl = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, lq = lane / 4;
  const uint32_t base = g1 + 2 * wg * kBox + (16 * wl + lq) * 128 + 4 * (lane % 4);
  const int c0 = kHalf * wg + 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < kPiece; ++q) {
    const int n = n0 + q, c = c0 + 8 * n;
    const bool in = f + c < f_end;
    const float2 bb = *reinterpret_cast<const float2*>(b1 + c);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float v0 = a1[4 * n + 2 * hi] + bb.x, v1 = a1[4 * n + 2 * hi + 1] + bb.y;
      const uint32_t g = in ? pack2(v0 * phi(v0), v1 * phi(v1)) : 0u;
      st_shared(base + hi * 1024 + (n / 8) * kBox + (((n % 8) ^ lq) << 4), g);
    }
  }
}

// grid (split, ceil(R / 64)), clusters of `split` along x; block r of a row
// tile takes F columns [r * run, (r + 1) * run). w1_map: (512, F) in boxes
// of 64 x 64; w2_map: (F, 512) in boxes of 32 rows x 64.
__global__ void __launch_bounds__(kThreads, 1)
chanff_chunk_fwd(const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 bf16* __restrict__ y, int R, int run) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xa = align_up(smem_raw);
  unsigned char* slabs = xa + kTileBytes;
  unsigned char* ring_base = slabs + 2 * kSlabBytes;
  Ring ring(ring_base);
  float* b1s = reinterpret_cast<float*>(ring_base + Ring::kSmem);  // the next slab's b1
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32;
  const int split = gridDim.x, rank = blockIdx.x, row0 = blockIdx.y * kRowTile;
  const int f_begin = rank * run, f_end = f_begin + run;
  const int nslab = (run + kSlab - 1) / kSlab;
  if (tid == 0) ring.init(ring_base);
  __syncthreads();

  if (warp >= kProducerWarp) {
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {  // the steps in the consumers' order: A0, then A(j+1), O(j)
      tma_prefetch_map(&w1_map);
      tma_prefetch_map(&w2_map);
      int i = 0;
      for (int j = -1; j < nslab; ++j) {
        if (j + 1 < nslab) {
          const int f = f_begin + (j + 1) * kSlab;
          for (int s = 0; s < kASteps; ++s, ++i) {
            const uint32_t st = ring.acquire(i, kFwdSlot, ring_base);
            for (int b = 0; b < kSlab / 64; ++b)
              tma_box(st + b * kBox, &w1_map, f + 64 * b, s * kAK, ring.bar(i));
          }
        }
        if (j >= 0) {
          const int f = f_begin + j * kSlab;
          for (int t = 0; t < kOSteps; ++t, ++i) {
            const uint32_t st = ring.acquire(i, kFwdSlot, ring_base);
            for (int b = 0; b < kD / 64; ++b)
              tma_box(st + b * kOBox, &w2_map, 64 * b, f + t * kOK, ring.bar(i));
          }
        }
      }
    }
    __syncwarp();
    cluster.sync();  // the partial tiles are staged
    cluster.sync();  // and summed
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  ln_tile(x, scale, bias, xa, row0, R, nullptr, nullptr, 0, 0);
  fence_proxy_async();  // xa is read by wgmma
  named_sync(1, kConsumers);

  const uint64_t xa_d = kdesc(smem_u32(xa));
  const uint32_t slab0 = smem_u32(slabs);
  float y0[64], y1[64], a1[kHalf / 2];
  zero(y0, 64);
  zero(y1, 64);
  int i = 0, held = -1;  // the ring's step; the last step whose products are not yet retired
  for (int j = -1; j < nslab; ++j) {
    const bool act = j + 1 < nslab;
    const uint32_t next = slab0 + ((j + 1) & 1) * kSlabBytes;
    const int f_next = f_begin + (j + 1) * kSlab;
    if (act) {  // issue slab j + 1's activation product, retiring each step as the next is queued
      b1s[tid] = f_next + tid < f_end ? b1[f_next + tid] : 0.0f;  // read after the products
      zero(a1, kHalf / 2);
      for (int s = 0; s < kASteps; ++s, ++i) {
        const uint32_t st = ring.wait(i);
        wgmma_fence();
        act_step(a1, xa_d, st, s, wg);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) ring.release(held);
        held = i;
      }
      named_sync(1, kConsumers);  // the slab's b1 is in shared memory
    }
    if (j < 0) {  // slab 0's GELU: no out product to overlap yet
      wgmma_wait<0>();
      ring.release(held);
      held = -1;
#pragma unroll
      for (int t = 0; t < kOSteps; ++t) gelu_piece(a1, t * kPiece, b1s, f_next, f_end, next, wg);
    } else {
      const uint64_t cur = kdesc(slab0 + (j & 1) * kSlabBytes);
#pragma unroll
      for (int t = 0; t < kOSteps; ++t, ++i) {
        const uint32_t st = ring.wait(i);
        wgmma_fence();
        out_step(y0, y1, cur, st, t, wg);
        wgmma_commit();
        wgmma_wait<1>();  // every group but this step's: slab j + 1's a1 is complete
        if (held >= 0) ring.release(held);
        held = i;
        if (act) gelu_piece(a1, t * kPiece, b1s, f_next, f_end, next, wg);
      }
      wgmma_wait<0>();
      ring.release(held);
      held = -1;
    }
    fence_proxy_async();        // the new slab is read by wgmma
    named_sync(1, kConsumers);  // both halves written; the old slab read by both warpgroups
  }

  // the partial y over xa and the slabs; this block's columns of the
  // cluster's, summed in rank order
  float* tile = reinterpret_cast<float*>(xa);
  stage_acc(tile, y0, 256 * wg);
  stage_acc(tile, y1, 256 * wg + 128);
  cluster.sync();
  const int width = kD / split, c0 = width * rank, groups = width / 4, n = kRowTile * groups;
  const float* part[kMaxSplit];
  cluster_tiles(part, tile, split, cluster);
  for (int q0 = tid; q0 < n; q0 += kRound * kConsumers) {  // x and the partials loaded first
    float4 xv[kRound], o[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int q = q0 + u * kConsumers, r = q / groups, c = c0 + 4 * (q % groups);
      const bool in = q < n && row0 + r < R;
      xv[u] = in ? load_bf16x4(x + (size_t)(row0 + r) * kD + c)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      o[u] = in ? *reinterpret_cast<const float4*>(part[0] + stg(r, c)) : xv[u];
    }
#pragma unroll
    for (int k = 1; k < kMaxSplit; ++k) {
      if (k >= split) break;
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int q = q0 + u * kConsumers, r = q / groups, c = c0 + 4 * (q % groups);
        if (q < n && row0 + r < R) {
          const float4 p = *reinterpret_cast<const float4*>(part[k] + stg(r, c));
          o[u] = make_float4(o[u].x + p.x, o[u].y + p.y, o[u].z + p.z, o[u].w + p.w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int q = q0 + u * kConsumers, r = q / groups, c = c0 + 4 * (q % groups);
      if (q >= n || row0 + r >= R) continue;
      const float4 b = *reinterpret_cast<const float4*>(b2 + c);
      *reinterpret_cast<uint2*>(y + (size_t)(row0 + r) * kD + c) =
          make_uint2(pack2((xv[u].x + o[u].x) + b.x, (xv[u].y + o[u].y) + b.y),
                     pack2((xv[u].z + o[u].z) + b.z, (xv[u].w + o[u].w) + b.w));
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}
}  // namespace fwd

// ------------------------------------------------------- backward, rows
namespace bwd {
constexpr int kSlab = kBwdSlab;
constexpr int kHalf = kSlab / 2;               // 64: a warpgroup's a1 and dg1 columns
constexpr int kASteps = kD / 64;               // activation steps a slab: 64 columns of D each
constexpr int kActBytes = 5 * kBox;            // w1 64 x 128 (two boxes), w2 128 x 64, dy 64 x 64
constexpr int kXSteps = 2 * (kSlab / 64);      // dxa steps a slab: 64 columns of F x two D halves
constexpr int kXBytes = 256 * 128;             // w1's K-major 256 x 64 box
constexpr int kSlabBytes = kRowTile * kSlab * 2;  // 16,384: a da1 slab, two K-major boxes
constexpr int kPiece = kHalf / 8 / kXSteps;    // n8 tiles of the epilogue after each dxa step
constexpr int kRed = 2 * 2 * 4 * kHalf;        // floats: column partials [wg][parity][warp][64]
using Ring = Pipe<kBwdStages, kBwdSlot>;
constexpr int kSmem =
    kAlign + kTileBytes + 2 * kSlabBytes + Ring::kSmem + kRowTile * 8 + kRed * 4 + kSlab * 4;
static_assert(kActBytes == kBwdSlot && kXBytes <= kBwdSlot, "a step fits a slot");
static_assert(kTileBytes + 2 * kSlabBytes + kBwdStages * kBwdSlot >= kRowTile * kD * 4 + 15 * 1024,
              "dxa and the tail's scratch are staged over xa, the slabs and the ring's slots");
static_assert(kRed * 4 >= kMaxSplit * kRowTile * 8,
              "the pushed row sums fit the column partials' room");
static_assert(kSmem <= 232448, "the backward must fit a block's shared memory");

// a1 += xa[:, 64 s ..] @ w1's box (warpgroup wg's 64 of the slab's columns);
// dg1 += dy's box @ w2's box^T (the same columns)
__device__ __forceinline__ void act_step(float* a1, float* dg, uint64_t xa, uint32_t st, int s,
                                         int wg) {
  const uint64_t w1 = mndesc(st + wg * kBox, kBox), dy = kdesc(st + 4 * kBox),
                 w2 = kdesc(st + (2 + wg) * kBox);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16<0, 1>(a1, kstep(xa, 64 * s + 16 * kk), w1 + kk * (2048 >> 4));
    wgmma_m64n64k16<0, 0>(dg, dy + kk * 2, w2 + kk * 2);
  }
}

// dxa (warpgroup's 256 columns: d0, d1) += da1_slab[:, 64 t ..] @ w1's box^T
__device__ __forceinline__ void dxa_step(float* d0, float* d1, uint64_t da, uint32_t st, int t) {
  const uint64_t b = kdesc(st);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = kstep(da, 64 * t + 16 * kk);
    wgmma_m64n128k16<0, 0>(d0, a, b + kk * 2);
    wgmma_m64n128k16<0, 0>(d1, a, b + ((128 * 128) >> 4) + kk * 2);
  }
}

// The epilogue of a1's and dg1's n8 tiles [n0, n0 + kPiece): a = a1 + b1,
// g1 = gelu(a), da1 = dg1 * gelu'(a); g1_c and da1_c to scratch (F column f
// of the warpgroup's column 0), da1_c into the slab; each column's sum of
// the f32 da1 over the warp's 16 rows into red[warp][64]. b1: the
// warpgroup's 64 columns of the slab's bias, in shared memory.
__device__ __forceinline__ void grad_piece(const float* a1, const float* dg, int n0,
                                           const float* b1, int f, int row0, int R,
                                           int F, bf16* __restrict__ g1, bf16* __restrict__ da1,
                                           uint32_t slab, float* red, int wg) {
  const int wl = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, lq = lane / 4;
  const uint32_t base = slab + wg * kBox + (16 * wl + lq) * 128 + 4 * (lane % 4);
  const int r0 = row0 + 16 * wl + lq;  // the thread's rows: r0 and r0 + 8
  const size_t o0 = (size_t)r0 * F + f + 2 * (lane % 4), o8 = (size_t)8 * F;
  const float* bp = b1 + 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < kPiece; ++q) {
    const int n = n0 + q;
    const float2 bb = *reinterpret_cast<const float2*>(bp + 8 * n);
    float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float g[2], d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = a1[4 * n + 2 * hi + e] + (e ? bb.y : bb.x);
        const float cdf = phi(a);
        g[e] = a * cdf;
        d[e] = dg[4 * n + 2 * hi + e] * (cdf + a * gelu_pdf(a));
      }
      const uint32_t dc = pack2(d[0], d[1]);
      st_shared(base + hi * 1024 + ((n ^ lq) << 4), dc);
      if (r0 + 8 * hi < R) {
        const size_t o = o0 + (hi ? o8 : 0) + 8 * n;
        *reinterpret_cast<uint32_t*>(g1 + o) = pack2(g[0], g[1]);
        *reinterpret_cast<uint32_t*>(da1 + o) = dc;
        cs0 += d[0];
        cs1 += d[1];
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {  // the lanes that share lane % 4: the warp's rows
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, off);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, off);
    }
    if (lane < 4)
      *reinterpret_cast<float2*>(red + wl * kHalf + 8 * n + 2 * lane) = make_float2(cs0, cs1);
  }
}

// the slab's db1 partials: warpgroup wg's 64 columns summed over its four
// warps in order, into part_f[tile][f ..]
__device__ __forceinline__ void colsum_slab(const float* red, float* __restrict__ part_f, int f,
                                            int F, int wg) {
  named_sync(2 + wg, 128);
  const int t = threadIdx.x % 128;
  if (t < kHalf) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[w * kHalf + t];
    part_f[(size_t)blockIdx.y * F + f + t] = s;
  }
}

// The LN backward of the row tile on this block's columns [c0, c0 + W), W =
// 512 / split, once every block's partial dxa tile is staged (and a cluster
// barrier): thread t takes the float4 group g = t % (W / 4) of every P-th row
// from t / (W / 4), P = 1024 / W, four rows a round of loads.
//   A: dxa = the partials summed in rank order (kept in place: no other block
//      reads this block's columns); the row sums of
//      dxn = dxa * scale and dxn * xn over the columns, a row's threads
//      (consecutive) adding by shuffles in a fixed tree, then their warps in
//      order; each block's row sums pushed to every block's rowrecv[rank];
//   then (a cluster barrier) the row means m1, m2 over all 512 columns, the
//      ranks' row sums in rank order;
//   B: dx = dy + rsig (dxn - m1 - xn m2), and the tile's column sums of
//      dxa * xn, dxa and dy (LN scale, LN bias, b2), each thread's rows, then
//      the row phases in order, into part_d.
// scratch: 14 KB of free shared memory past the staged tile (in the ring's
// slots); rowrecv: [kMaxSplit][64] row sums (4 KB).
__device__ void ln_bwd_tile(float* tile, float* scratch, float2* rowrecv, const float2* stats,
                            const bf16* __restrict__ x, const bf16* __restrict__ dy,
                            const float* __restrict__ scale, bf16* __restrict__ dx,
                            float* __restrict__ part_d, int row0, int R, int rank, int split) {
  constexpr int kU = 4;  // rows a round
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32;
  const int W = kD / split, c0 = W * rank, G = W / 4, P = kConsumers / G, M = kRowTile / P;
  const int g = tid % G, p = tid / G, cc = 4 * g, c = c0 + cc;
  const int span = G < 32 ? G : 32;  // lanes of a row in one warp
  float* colpart = scratch;                                          // [P][3][W]
  float2* rowwarp = reinterpret_cast<float2*>(scratch + 3 * kConsumers * 4);  // [64][4]
  float2* rowstat = rowwarp + 4 * kRowTile;                          // [64]: the row means
  const float4 sc = *reinterpret_cast<const float4*>(scale + c);
  const float* part[kMaxSplit];
  cluster_tiles(part, tile, split, cluster);

  for (int m0 = 0; m0 < M; m0 += kU) {
    float4 xv[kU], o[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = p + P * (m0 + u), row = row0 + r;
      xv[u] = row < R ? load_bf16x4(x + (size_t)row * kD + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      o[u] = *reinterpret_cast<const float4*>(part[0] + stg(r, c));
    }
#pragma unroll
    for (int k = 1; k < kMaxSplit; ++k) {
      if (k >= split) break;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float4 q = *reinterpret_cast<const float4*>(part[k] + stg(p + P * (m0 + u), c));
        o[u] = make_float4(o[u].x + q.x, o[u].y + q.y, o[u].z + q.z, o[u].w + q.w);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = p + P * (m0 + u);
      *reinterpret_cast<float4*>(tile + stg(r, c)) = o[u];
      const float2 st = stats[r];
      const float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
      const float os[4] = {o[u].x, o[u].y, o[u].z, o[u].w};
      const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = os[e] * scs[e];
        s1 += d;
        s2 += d * ((xs[e] - st.x) * st.y);
      }
      for (int off = 1; off < span; off *= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane % span == 0) rowwarp[r * 4 + g / 32] = make_float2(s1, s2);
    }
  }
  named_sync(1, kConsumers);
  if (tid < kRowTile) {  // the block's row sums, pushed to every block of the cluster
    float2 t = rowwarp[tid * 4];
    for (int w = 1; w < (G + 31) / 32; ++w) {
      const float2 q = rowwarp[tid * 4 + w];
      t = make_float2(t.x + q.x, t.y + q.y);
    }
    for (int k = 0; k < split; ++k) cluster.map_shared_rank(rowrecv, k)[rank * kRowTile + tid] = t;
  }
  cluster.sync();  // past here no block reads another's shared memory
  if (tid < kRowTile) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int k = 0; k < split; ++k) {
      const float2 q = rowrecv[k * kRowTile + tid];
      t1 += q.x;
      t2 += q.y;
    }
    rowstat[tid] = make_float2(t1 / kD, t2 / kD);
  }
  named_sync(1, kConsumers);

  float cs[3][4] = {};
  for (int m0 = 0; m0 < M; m0 += kU) {
    float4 xv[kU], gv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = row0 + p + P * (m0 + u);
      const bool in = row < R;
      xv[u] = in ? load_bf16x4(x + (size_t)row * kD + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      gv[u] = in ? load_bf16x4(dy + (size_t)row * kD + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = p + P * (m0 + u), row = row0 + r;
      if (row >= R) continue;
      const float2 st = stats[r], mm = rowstat[r];
      const float4 o = *reinterpret_cast<const float4*>(tile + stg(r, c));
      const float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w}, os[4] = {o.x, o.y, o.z, o.w};
      const float gs[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w}, scs[4] = {sc.x, sc.y, sc.z, sc.w};
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xn = (xs[e] - st.x) * st.y;
        out[e] = gs[e] + st.y * (os[e] * scs[e] - mm.x - xn * mm.y);
        cs[0][e] += os[e] * xn;
        cs[1][e] += os[e];
        cs[2][e] += gs[e];
      }
      *reinterpret_cast<uint2*>(dx + (size_t)row * kD + c) =
          make_uint2(pack2(out[0], out[1]), pack2(out[2], out[3]));
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    *reinterpret_cast<float4*>(colpart + (p * 3 + k) * W + cc) =
        make_float4(cs[k][0], cs[k][1], cs[k][2], cs[k][3]);
  named_sync(1, kConsumers);
  for (int j = tid; j < 3 * W; j += kConsumers) {  // the row phases in order
    const int k = j / W, col = j % W;
    float t = 0.0f;
    for (int q = 0; q < P; ++q) t += colpart[(q * 3 + k) * W + col];
    part_d[((size_t)blockIdx.y * 3 + k) * kD + c0 + col] = t;
  }
}

// grid (split, ceil(R / 64)), clusters of `split` along x, as the forward's.
// w1_map: (512, F) in boxes of 64 x 64; w1k_map: the same in boxes of 256
// rows x 64; w2_map: (F, 512) in boxes of 128 rows x 64; dy_map: (R, 512) in
// boxes of 64 x 64.
__global__ void __launch_bounds__(kThreads, 1)
chanff_chunk_bwd_rows(const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w1k_map,
                      const __grid_constant__ CUtensorMap w2_map,
                      const __grid_constant__ CUtensorMap dy_map, const bf16* __restrict__ x,
                      const bf16* __restrict__ dy, const float* __restrict__ scale,
                      const float* __restrict__ bias, const float* __restrict__ b1,
                      bf16* __restrict__ dx, bf16* __restrict__ xa_out, bf16* __restrict__ g1,
                      bf16* __restrict__ da1, float* __restrict__ part_d,
                      float* __restrict__ part_f, int R, int F, int run) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xa = align_up(smem_raw);
  unsigned char* slabs = xa + kTileBytes;
  unsigned char* ring_base = slabs + 2 * kSlabBytes;
  Ring ring(ring_base);
  float2* stats = reinterpret_cast<float2*>(ring_base + Ring::kSmem);
  float* red = reinterpret_cast<float*>(stats + kRowTile);
  float* b1s = red + kRed;  // the next slab's b1
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32;
  const int split = gridDim.x, rank = blockIdx.x, row0 = blockIdx.y * kRowTile;
  const int f_begin = rank * run, nslab = run / kSlab;
  const int width = kD / split, c0 = width * rank;  // this block's columns at the end
  if (tid == 0) ring.init(ring_base);
  __syncthreads();

  if (warp >= kProducerWarp) {
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {  // A0, then A(j+1), X(j)
      tma_prefetch_map(&w1_map);
      tma_prefetch_map(&w1k_map);
      tma_prefetch_map(&w2_map);
      tma_prefetch_map(&dy_map);
      int i = 0;
      for (int j = -1; j < nslab; ++j) {
        if (j + 1 < nslab) {
          const int f = f_begin + (j + 1) * kSlab;
          for (int s = 0; s < kASteps; ++s, ++i) {
            const uint32_t st = ring.acquire(i, kActBytes, ring_base);
            tma_box(st, &w1_map, f, 64 * s, ring.bar(i));
            tma_box(st + kBox, &w1_map, f + 64, 64 * s, ring.bar(i));
            tma_box(st + 2 * kBox, &w2_map, 64 * s, f, ring.bar(i));
            tma_box(st + 4 * kBox, &dy_map, 64 * s, row0, ring.bar(i));
          }
        }
        if (j >= 0) {
          const int f = f_begin + j * kSlab;
          for (int p = 0; p < kXSteps; ++p, ++i) {
            const uint32_t st = ring.acquire(i, kXBytes, ring_base);
            tma_box(st, &w1k_map, f + 64 * (p / 2), 256 * (p % 2), ring.bar(i));
          }
        }
      }
    }
    __syncwarp();
    cluster.sync();  // the partial tiles are staged
    cluster.sync();  // read, and the row sums pushed
    return;
  }

  regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  ln_tile(x, scale, bias, xa, row0, R, stats, xa_out, c0, c0 + width);
  fence_proxy_async();
  named_sync(1, kConsumers);

  const uint64_t xa_d = kdesc(smem_u32(xa));
  const uint32_t slab0 = smem_u32(slabs);
  float d0[64], d1[64], a1[kHalf / 2], dg[kHalf / 2];
  zero(d0, 64);
  zero(d1, 64);
  int i = 0, held = -1;
  for (int j = -1; j < nslab; ++j) {
    const bool act = j + 1 < nslab;
    const uint32_t next = slab0 + ((j + 1) & 1) * kSlabBytes;
    const int f_next = f_begin + (j + 1) * kSlab + kHalf * wg;  // this warpgroup's columns
    float* red_next = red + (wg * 2 + ((j + 1) & 1)) * 4 * kHalf;
    if (act) {
      if (tid < kSlab) b1s[tid] = b1[f_begin + (j + 1) * kSlab + tid];  // read after the products
      zero(a1, kHalf / 2);
      zero(dg, kHalf / 2);
      for (int s = 0; s < kASteps; ++s, ++i) {
        const uint32_t st = ring.wait(i);
        wgmma_fence();
        act_step(a1, dg, xa_d, st, s, wg);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) ring.release(held);
        held = i;
      }
      named_sync(1, kConsumers);  // the slab's b1 is in shared memory
    }
    if (j < 0) {
      wgmma_wait<0>();
      ring.release(held);
      held = -1;
#pragma unroll
      for (int p = 0; p < kXSteps; ++p)
        grad_piece(a1, dg, p * kPiece, b1s + kHalf * wg, f_next, row0, R, F, g1, da1, next,
                   red_next, wg);
    } else {
      const uint64_t cur = kdesc(slab0 + (j & 1) * kSlabBytes);
#pragma unroll
      for (int p = 0; p < kXSteps; ++p, ++i) {
        const uint32_t st = ring.wait(i);
        if (p % 2 == wg) {
          wgmma_fence();
          dxa_step(d0, d1, cur, st, p / 2);
          wgmma_commit();
          wgmma_wait<1>();  // every group but this step's: slab j + 1's a1 and dg1 are complete
          if (held >= 0) ring.release(held);
          held = i;
        } else {  // the other warpgroup's half of D
          ring.release(i);
        }
        // slab j + 1's epilogue, a quarter after each step from this
        // warpgroup's first own one (until then its a1 and dg1 may be in flight)
        if (act) {
          if (wg == 0)
            grad_piece(a1, dg, p * kPiece, b1s + kHalf * wg, f_next, row0, R, F, g1, da1, next,
                   red_next, wg);
          else if (p >= 1)
            grad_piece(a1, dg, (p - 1) * kPiece, b1s + kHalf * wg, f_next, row0, R, F, g1, da1,
                       next, red_next, wg);
        }
      }
      wgmma_wait<0>();
      ring.release(held);
      held = -1;
      if (act && wg == 1)
        grad_piece(a1, dg, (kXSteps - 1) * kPiece, b1s + kHalf * wg, f_next, row0, R, F, g1, da1,
                   next, red_next, wg);
    }
    if (act) colsum_slab(red_next, part_f, f_next, F, wg);
    fence_proxy_async();
    named_sync(1, kConsumers);
  }

  // the partial dxa over xa, the slabs and the ring; this block's columns of
  // the cluster's, summed in rank order
  float* tile = reinterpret_cast<float*>(xa);
  stage_acc(tile, d0, 256 * wg);
  stage_acc(tile, d1, 256 * wg + 128);
  cluster.sync();
  ln_bwd_tile(tile, tile + kRowTile * kD, reinterpret_cast<float2*>(red), stats, x, dy, scale, dx,
              part_d, row0, R, rank, split);
}
}  // namespace bwd

// the runs are whole chunks, so whole backward slabs; a forward run may end
// inside a slab
bool shapes_ok(int R, int D, int F, int fc, int row_tile, int split) {
  if (D != kD || R <= 0 || F <= 0 || row_tile != kRowTile) return false;
  if (fc != 128 && fc != 256 && fc != 512 && fc != 1024) return false;
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) != 0) return false;
  return F % (split * fc) == 0;
}
static_assert(128 % kBwdSlab == 0, "a chunk is whole backward slabs");

}  // namespace

extern "C" {

// Shapes the kernels take: D == 512, fc in {128, 256, 512, 1024}, F a
// multiple of fc, R >= 1; row_tile == 64; split a power of two up to 8 that
// cuts F into equal runs of whole chunks (the blocks of a row tile's
// cluster). bf16 x, dy, w1, w2, y, dx and scratch; f32 vectors. All pointers
// 16-byte aligned and contiguous.
int pips_chanff_chunk_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* y, int R, int D, int F, int fc, int row_tile, int split,
                          int device, void* stream) {
  if (!shapes_ok(R, D, F, fc, row_tile, split)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap w1_map, w2_map;
  err = make_map_2d_bf16(&w1_map, w1, F, kD, (uint64_t)F * 2, fwd::kAK);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w2_map, w2, kD, F, kD * 2, fwd::kOK);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(fwd::chanff_chunk_fwd, split, (R + kRowTile - 1) / kRowTile,
                             fwd::kSmem, static_cast<cudaStream_t>(stream), w1_map, w2_map,
                             static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
                             static_cast<const float*>(ln_bias), static_cast<const float*>(b1),
                             static_cast<const float*>(b2), static_cast<bf16*>(y), R, F / split);
}

// The backward's row phase: dx; scratch xa (R*D), g1 and da1 (R*F) in bf16
// and the f32 partials part_d (ceil(R/64), 3, D) and part_f (ceil(R/64), F)
// in chanff_rows.cuh's layout, tiles of row_tile = 64 rows, for
// pips_chanff_bwd_finish.
int pips_chanff_chunk_bwd_rows(const void* x, const void* dy, const void* ln_scale,
                               const void* ln_bias, const void* w1, const void* b1,
                               const void* w2, void* dx, void* xa, void* g1, void* da1,
                               void* part_d, void* part_f, int R, int D, int F, int fc,
                               int row_tile, int split, int device, void* stream) {
  if (!shapes_ok(R, D, F, fc, row_tile, split)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap w1_map, w1k_map, w2_map, dy_map;
  err = make_map_2d_bf16(&w1_map, w1, F, kD, (uint64_t)F * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w1k_map, w1, F, kD, (uint64_t)F * 2, 256);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w2_map, w2, kD, F, kD * 2, bwd::kSlab);
  if (err == cudaSuccess) err = make_map_2d_bf16(&dy_map, dy, kD, R, kD * 2, kRowTile);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster(
      bwd::chanff_chunk_bwd_rows, split, (R + kRowTile - 1) / kRowTile, bwd::kSmem,
      static_cast<cudaStream_t>(stream), w1_map, w1k_map, w2_map, dy_map,
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const float*>(b1), static_cast<bf16*>(dx), static_cast<bf16*>(xa),
      static_cast<bf16*>(g1), static_cast<bf16*>(da1), static_cast<float*>(part_d),
      static_cast<float*>(part_f), R, F, F / split);
}

// Clusters of `split` blocks of the forward (backward 0) or the backward's
// row kernel (1) that the card holds at once (cudaOccupancyMaxActiveClusters),
// or minus a CUDA error.
int pips_chanff_chunk_max_clusters(int backward, int split, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  return backward ? max_clusters(bwd::chanff_chunk_bwd_rows, split, bwd::kSmem)
                  : max_clusters(fwd::chanff_chunk_fwd, split, fwd::kSmem);
}

}  // extern "C"
