// One conv pass of the fused stage-1 residual block: a 3x3, stride-1, SAME
// 64 -> 64 convolution with an f32 bias, NHWC (torch.channels_last) in and
// out, with
//   * an optional prologue: the input's in-image pixels become
//     relu(x * scale[b, c] + shift[b, c]) in f32 (a multiply, then an add),
//     rounded to x's dtype before the products; the SAME padding stays zero;
//   * an epilogue that writes, for each (image, tile), the f32 (sum, sumsq)
//     over the tile's pixels of the unrounded output (bias included): the
//     instance norm's statistics. y is that output rounded once.
//
// Replaces the TPU kernel pips_tpu/kernels/block_pallas.py:_conv_pass
// (pallas_call of _conv3x3_stats_kernel), which res_block64 runs twice
// forward (conv1; conv2 with the first norm as its prologue) and twice
// backward (the dgrads: prologue off, zero bias, rotated in/out-swapped
// weights; their statistics unused).
//
// What bounds it on an H100: as the plain conv (conv3x3_fwd.cu), 2*576*64
// operations per output pixel against 2*64*2 bytes (x read once, y written
// once, bf16); the statistics add 512 bytes per image. At 8x64x192x256 that is
// 29.0 GFLOP (0.029 ms at 989 TFLOP/s) against 100.7 MB (0.030 ms at
// 3.35 TB/s): level, so the pass must stream x and y at the memory rate and
// keep the tensor cores busy, and the prologue and the statistics must ride
// on the loads and the accumulators rather than cost passes of their own.
//
// Design. The TPU kernel works on the W-space-to-depth tensor (128 lanes) and
// pair-combines the statistics of the two s2d halves; Hopper has no lane width
// to fill, so this is an implicit GEMM over K = 9 taps x 64 channels.
// bf16 (conv3x3_stats_bf16): persistent blocks, one an SM (222 KB of shared
// memory, 16 warps), walk output tiles of 4 x 30 pixels; a tile's haloed
// input box is 6 x 32 pixels (1.6 input pixels an output pixel). Roles:
//   * three consumer warpgroups take the tiles by turns. The first thread of
//     each copies the boxes of its next two tiles into its two slots of a
//     six-slot ring, each by one TMA load (a 4D tensor map over the NHWC
//     input, 128-byte swizzled, on an mbarrier); coordinates outside the
//     image read as zero, which is the SAME padding;
//   * a prologue warpgroup (with the prologue on) applies relu(x * scale +
//     shift) to each box's in-image pixels in place as it lands, masked by
//     their coordinates, so the padding never sees the affine (a border
//     reading relu(shift) would be the bug to avoid), and hands the slot on
//     by a second mbarrier: once a pixel, not once for each of its nine taps;
//   * a consumer warpgroup computes y^T (64 outputs x 128 pixels) = W^T X as
//     36 wgmma m64n128k16, one per (tap, 16 channels), issued at once, both
//     operands from shared memory: A is the weight, resident as [tap][o][c]
//     K-major 128-byte swizzled rows (laid out once a block from
//     (O, C, 3, 3) by 16-byte loads); B is the box's first four rows, read
//     straight from the TMA's swizzled tile shifted by the tap: the swizzle
//     follows the shared-memory address, so a descriptor may start at any
//     pixel row. B's 128 rows are the four box rows whole, 32 pixels each,
//     so every tap shifts them alike and the two last columns of a row are
//     products that are no outputs (6% of the tensor work). The weight's
//     layout and the products are conv3x3_tiles.cuh's, which conv3x3_fwd.cu
//     shares.
// Why three: one warpgroup's products alone run at ~156 cycles a product
// (the tensor cores' rate is 64), two together at ~85 each; with two
// warpgroups both epilogues fell together and the tensor cores idled, with
// three two are in products while the third finishes its tile (clock64
// marks and tools/profile_pipelines.py on the card; the pixels as M, A by
// ldmatrix, and taking turns or two accumulator chains a warpgroup measured
// slower).
// The epilogue: the accumulators start from the f32 bias; each warp owns 16
// outputs, so the tile's (sum, sumsq) of an output is a tree sum of a
// thread's 32 pixels and two shuffles over the four lanes that share the
// output, one row per tile; the rounded outputs are staged by stmatrix
// (transposed to [pixel][o], swizzled as the box) into the tile's own ring
// slot, whose products are done, and written back by one TMA store (clipped
// at the image's edge); the slot takes its next box once the store has read
// it. Rows never share a writer: no atomics, the same bits every call; the
// wrapper sums the rows (B, 2, 64, T) -> (B, 2, 64), as JAX sums its grid
// steps outside the kernel. f32 (conv3x3_stats_f32) runs f32 FMAs (mma.sync
// in f32 would be TF32), bound by the FMA rate (2*576 FLOP per (pixel,
// output) at 67 TFLOP/s): conv3x3_f32_tiles.cuh's mainloop, which
// conv3x3_fwd.cu's conv3x3_f32 shares (256 threads on an 8 x 32 pixel tile
// times 64, 32, 16 or 8 outputs, a run of 8, 4, 2 or 1 pixels x 8 outputs
// a thread, three cp.async stages of 8 channels), the prologue applied in
// place to each thread's own copies once they have landed; a tile's
// statistics are a tree over a thread's run, a butterfly over its warp and,
// for runs under 8 pixels, the group's warps in order.
//
// Plain C ABI (loaded with ctypes): pips_conv3x3_stats returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "conv3x3_f32_tiles.cuh"
#include "conv3x3_tiles.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;  // input channels = outputs = 64

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the prologue on one value: relu(v * scale + shift), no fused multiply-add,
// so that it rounds as the plain version's two PyTorch ops do
__device__ __forceinline__ float affine_relu(float v, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(v, scale), shift), 0.0f);
}

// ---------------------------------------------------- bf16 (wgmma, TMA ring)
namespace tc {
constexpr int TH = 4;                    // output tile rows
constexpr int TW = 30;                   // output tile columns
constexpr int HR = TH + 2, HC = TW + 2;  // the haloed input box: 6 x 32 pixels
// the products' N: box rows 0 .. TH - 1 whole, as if each held HC outputs
// (the last two of a row are no outputs); a tap shifts all of them alike
constexpr int kN = TH * HC;              // 128
constexpr int kWGs = 3;                  // consumer warpgroups, taking the tiles by turns
constexpr int kSlotsWG = 2;              // ring slots of a warpgroup: this tile and the next
constexpr int kStages = kWGs * kSlotsWG;
constexpr int kConsumers = 128 * kWGs;
constexpr int kPrologueThreads = 128;    // one warpgroup: the prologue, in place in the ring
constexpr int kThreads = kConsumers + kPrologueThreads;  // 16 warps: 128 registers a thread
constexpr uint32_t kBoxBytes = HR * HC * 128;                      // 24,576: one TMA box
constexpr size_t kStageBytes = (kBoxBytes + 1023) / 1024 * 1024;   // 24,576
constexpr size_t kWBytes = conv3::kWBytes;                         // 73,728: [tap][o][c]
constexpr size_t kOutBytes = (size_t)TH * TW * 128;                // 15,360: a tile's outputs
constexpr size_t kJunkBytes = 128;  // where the two columns past a row's outputs are stored
// 1024 bytes to align the tiles, the ring (a tile's outputs are staged in its
// own slot once its products are done), the weight, the junk row, 2 * kStages
// mbarriers
constexpr size_t kSmem = 1024 + kStages * kStageBytes + kWBytes + kJunkBytes +
                         2 * kStages * 8;  // 222,432: one block an SM
static_assert(kStageBytes % 1024 == 0 && kWBytes % 1024 == 0 && kOutBytes <= kStageBytes,
              "tiles 1024-byte aligned; a tile's outputs fit its slot");
static_assert(kN == 128 && HC == conv3::kBoxCols, "a box row is four n8 tiles of the products");

// output tiles of 4 x 30 pixels per image: the rows of partial statistics
__host__ __device__ constexpr int tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// the prologue on one haloed box in place: relu(x * scale + shift), rounded
// to bf16, on its in-image pixels (the zero padding stays zero). 128 threads:
// thread t takes 16-byte chunk t % 8 (sc, sh: its eight channels' scale and
// shift) of pixels t / 8, t / 8 + 16, ..., four loads in flight
__device__ __forceinline__ void prologue_box(unsigned char* st, int t, const float* sc,
                                             const float* sh, int h0, int w0, int H, int W) {
  const int jc = t % 8;
  const bool interior = h0 >= 1 && h0 - 1 + HR <= H && w0 >= 1 && w0 - 1 + HC <= W;
  static_assert(HR * HC % 64 == 0, "four pixels a thread at a time");
#pragma unroll
  for (int k0 = 0; k0 < HR * HC / 16; k0 += 4) {
    uint4 v[4];
    uint4* ptr[4];
    bool in[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = t / 8 + 16 * (k0 + u);
      const int h = h0 - 1 + p / HC, col = w0 - 1 + p % HC;
      in[u] = interior || (h >= 0 && h < H && col >= 0 && col < W);
      ptr[u] = reinterpret_cast<uint4*>(st + swz128(p, jc));
      v[u] = *ptr[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(pr[k]);
        pr[k] = __floats2bfloat162_rn(affine_relu(f.x, sc[2 * k], sh[2 * k]),
                                      affine_relu(f.y, sc[2 * k + 1], sh[2 * k + 1]));
      }
      if (in[u]) *ptr[u] = v[u];
    }
  }
}

// x_map / y_map: x and y as (64, W, H, B) bf16, boxes of (64, HC, HR, 1) and
// (64, TW, TH, 1), 128-byte swizzled. part (B, 2, 64, tiles).
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_stats_bf16(__grid_constant__ const CUtensorMap x_map,
                   __grid_constant__ const CUtensorMap y_map, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ aff,
                   float* __restrict__ part, int B, int H, int W, int prologue) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ws = xs + kStages * kStageBytes;
  unsigned char* junk = ws + kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(junk + kJunkBytes);
  uint64_t* ready = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = tiles(H, W);
  const int ntiles = B * per_image;
  // the block's tile i is tile blockIdx.x + i * gridDim.x; consumer
  // warpgroup i % 3 takes it, as its tile j = i / 3, through ring slot
  // (i % 3) * 2 + j % 2
  auto tile_at = [&](int i, int& b, int& h0, int& w0) {
    const int t = blockIdx.x + i * gridDim.x;
    b = t / per_image;
    const int ti = t % per_image;
    h0 = ti / tiles_w * TH;
    w0 = (ti % tiles_w) * TW;
    return t < ntiles;
  };
  auto slot_of = [](int i) { return (i % kWGs) * kSlotsWG + (i / kWGs) % kSlotsWG; };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kPrologueThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the prologue warpgroup: relu(x * scale + shift), rounded to bf16, on
    // the in-image pixels of each box as it lands, in place, the block's
    // tiles in order; the zero padding stays zero. A thread's 16-byte chunk
    // is the same for every item (the stride is a multiple of 8), so its
    // eight channels' scale and shift are loaded once a tile
    if (!prologue) return;
    const int ptid = tid - kConsumers, jc = ptid % 8;
    int b, h0, w0;
    for (int i = 0; tile_at(i, b, h0, w0); ++i) {
      const int s = slot_of(i);
      mbar_wait(&full[s], (i / kStages) & 1);
      const float4* a4 = reinterpret_cast<const float4*>(aff + (size_t)b * 2 * kC + jc * 8);
      const float4 a0 = a4[0], a1 = a4[1], c0 = a4[kC / 4], c1 = a4[kC / 4 + 1];
      const float sc[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float sh[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      unsigned char* st = xs + s * kStageBytes;
      prologue_box(st, ptid, sc, sh, h0, w0, H, W);
      fence_proxy_async();  // the products and the next TMA copy read these writes
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // warpgroup wg takes the block's tiles wg, wg + 3, ..., so that two run
  // products while the third finishes a tile. Its first thread copies each
  // of its tiles' haloed boxes into its two ring slots by one TMA load (a 4D
  // box; pixels outside the image, the SAME padding, read as zero), a tile
  // ahead: a slot is refilled once the TMA store of the outputs staged there
  // has read them
  const int wg = warp / 4, wl = warp % 4, ctid = tid % 128;
  const int gq = lane / 4, tq = lane % 4;
  auto load = [&](int i) {
    int b, h0, w0;
    if (!tile_at(i, b, h0, w0)) return;
    const int s = slot_of(i);
    mbar_arrive_expect_tx(&full[s], kBoxBytes);
    tma_load_4d(xs + s * kStageBytes, &x_map, 0, w0 - 1, h0 - 1, b, &full[s]);
  };
  if (ctid == 0)
    for (int k = 0; k < kSlotsWG; ++k) load(wg + k * kWGs);
  // the weight, once a block, while the first boxes land: A of the products
  conv3::stage_weight(ws, w, tid, kConsumers);
  fence_proxy_async();  // the products read the weight through the async proxy
  named_sync(1, kConsumers);
  // this thread's outputs o1 = 16 wl + gq and o1 + 8 (accumulator rows)
  const int o1 = 16 * wl + gq;
  const float bias1 = bias[o1], bias2 = bias[o1 + 8];

  int b, h0, w0;
  for (int i = wg; tile_at(i, b, h0, w0); i += kWGs) {
    const int s = slot_of(i);
    mbar_wait(prologue ? &ready[s] : &full[s], (i / kStages) & 1);
    const int ti = (blockIdx.x + i * gridDim.x) % per_image;
    unsigned char* st = xs + s * kStageBytes;

    // y^T (64 outputs x 128 box pixels) = W^T X: per (tap, 16 channels) one
    // wgmma m64n128k16, all 36 issued at once (conv3x3_tiles.cuh)
    float acc[64];  // from the f32 bias: accumulator 4 n + 2 hi + e is output o1 + 8 hi
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = j & 2 ? bias2 : bias1;
    wgmma_fence();
    conv3::products<kN>(acc, ws, st);
    wgmma_commit();
    wgmma_wait<0>();

    // epilogue: every warp's products from this box are done, so its slot
    // takes the outputs
    named_sync(2 + wg, 128);
    // accumulator 4 n + 2 hi + e: output o1 + 8 hi, box pixel q = 8 n + 2 tq
    // + e (row n / 4, column 8 (n % 4) + 2 tq + e: an output where the
    // column is below TW and the pixel in the image; bit 2 n + e of `valid`).
    // Statistics: this thread's values summed as a tree (pairs, the two
    // n8 tiles of a step, the row's two steps, the rows), then over the four
    // lanes that share gq (xor 1, 2): each warp owns its 16 outputs, so lane
    // tq = 0 writes the tile's (sum, sumsq) of its two. Outputs: the values
    // rounded once, staged [pixel][o] swizzled as the store's box by
    // stmatrix (transposed: a row of the store is a pixel's 8 outputs); the
    // two columns past a row's outputs go to a junk row
    uint32_t cols = 0u, valid = 0u;  // a row's 8 bits (8 j + 2 tq + e < TW, in the image)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * (j / 2) + 2 * tq + j % 2;
      cols |= (c < TW && w0 + c < W ? 1u : 0u) << j;
    }
#pragma unroll
    for (int row = 0; row < TH; ++row) valid |= h0 + row < H ? cols << (8 * row) : 0u;
    float rs[TH][2][2], ps[2][2];  // [row][output o1 + 8 hi][sum, sumsq]; this step's
#pragma unroll
    for (int n2 = 0; n2 < kN / 16; ++n2) {
      uint32_t r[4];  // matrices (n, hi): (2 n2, 0), (2 n2, 1), (2 n2 + 1, 0), (2 n2 + 1, 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 2 * n2 + k / 2, hi = k % 2;
        const float v0 = acc[4 * n + 2 * hi], v1 = acc[4 * n + 2 * hi + 1];
        const float m0 = valid >> (2 * n) & 1u ? v0 : 0.0f;
        const float m1 = valid >> (2 * n + 1) & 1u ? v1 : 0.0f;
        const float ds = m0 + m1, dq = fmaf(m1, m1, m0 * m0);
        ps[hi][0] = k < 2 ? ds : ps[hi][0] + ds;
        ps[hi][1] = k < 2 ? dq : ps[hi][1] + dq;
        r[k] = bits(__floats2bfloat162_rn(v0, v1));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float& row = rs[n2 / 2][k / 2][k % 2];
        row = n2 % 2 ? row + ps[k / 2][k % 2] : ps[k / 2][k % 2];
      }
      // lane 8 k + j: row j of matrix k, pixel 8 n + j, outputs 16 wl + 8 hi ..
      const int k = lane / 8, n = 2 * n2 + k / 2, c = 8 * (n % 4) + lane % 8;
      unsigned char* dst = c < TW ? st + swz128((n / 4) * TW + c, 2 * wl + k % 2) : junk;
      stmatrix_x4_trans(dst, r[0], r[1], r[2], r[3]);
    }
    float sq[2][2];  // [output o1 + 8 hi][sum, sumsq]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int hi = k / 2, j = k % 2;
      sq[hi][j] = (rs[0][hi][j] + rs[1][hi][j]) + (rs[2][hi][j] + rs[3][hi][j]);
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sq[k / 2][k % 2] += __shfl_xor_sync(0xffffffffu, sq[k / 2][k % 2], off);
    if (tq == 0) {
      float* pt = part + ((size_t)b * 2 * kC + o1) * per_image + ti;
      pt[0] = sq[0][0];
      pt[8 * per_image] = sq[1][0];
      pt[kC * per_image] = sq[0][1];
      pt[(kC + 8) * per_image] = sq[1][1];
    }
    fence_proxy_async();  // the staged outputs are the TMA store's to read
    named_sync(2 + wg, 128);
    if (ctid == 0) {  // the store, then the slot's next box once the store has read it
      tma_store_4d(&y_map, st, 0, w0, h0, b);
      bulk_commit();
      bulk_wait_read<0>();
      load(i + kWGs * kSlotsWG);
    }
  }
  if (ctid == 0) bulk_wait<0>();  // the last stores are complete before the block ends
}
}  // namespace tc

// ------------------------------------------- f32 (SIMT, register tiles)
namespace f32 {
// a block: an 8 x 32 pixel tile times OG outputs, on conv3x3_f32_tiles.cuh's
// mainloop, with the prologue applied to each thread's own copies of a chunk
// once they have landed. Epilogue: the f32 bias added to the f32 sums, each
// thread writing its pixels' 8 outputs as two float4 each; the statistics of
// a thread's 8 outputs a tree over its in-image pixels, then a butterfly
// over the warp's 32 lanes, then (where a run is shorter than 8 pixels and
// an output group spans 8 / run warps) those warps' sums added in warp order
// through shared memory. One writer a row, fixed orders: the same bits every
// call.
template <int OG>
__global__ void __launch_bounds__(conv3f::kThreads, 2)
conv3x3_stats_f32(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ aff,
                  float* __restrict__ y, float* __restrict__ part, int B, int H, int W,
                  int prologue, int groups) {
  constexpr int PX = conv3f::run(OG), OT = conv3f::OT;
  constexpr int kWarps = conv3f::Thread<OG>::kWarpsPerGroup;  // warps sharing 8 outputs
  extern __shared__ __align__(16) float smem_f[];
  const conv3f::Tile t = conv3f::tile_of(H, W, OG, groups);
  const conv3f::Thread<OG> th;
  float acc[PX][OT];
  conv3f::mainloop<OG>(acc, th, smem_f, x, w, t, H, W, kC, kC, [&](float* xs, int c0) {
    if (!prologue) return;
    // this thread's copies all hold the same 4 channels: their scale and
    // shift once a chunk (from the kernel's parameter: no pointer held
    // across the loop, which spilled)
    const float* sp = aff + (size_t)t.b * 2 * kC + c0 + 4 * (threadIdx.x % (conv3f::CC / 4));
    const float4 sc = __ldg(reinterpret_cast<const float4*>(sp));
    const float4 sh = __ldg(reinterpret_cast<const float4*>(sp + kC));
    conv3f::for_box(t, H, W, kC, c0, [&](int dst, size_t, bool in, int) {
      if (!in) return;
      float4* v = reinterpret_cast<float4*>(xs + dst);
      const float4 a = *v;
      *v = make_float4(affine_relu(a.x, sc.x, sh.x), affine_relu(a.y, sc.y, sh.y),
                       affine_relu(a.z, sc.z, sh.z), affine_relu(a.w, sc.w, sh.w));
    });
  });

  const int lane = threadIdx.x % 32, o = t.o0 + th.o;
  const int h = t.h0 + th.r, c = t.w0 + th.c;
  const float4 b0 = *reinterpret_cast<const float4*>(bias + o);
  const float4 b1 = *reinterpret_cast<const float4*>(bias + o + 4);
  const float bv[OT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  float* yr = y + (((size_t)t.b * H + h) * W + c) * kC + o;
  float v[PX][OT];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const bool in = h < H && c + p < W;
#pragma unroll
    for (int k = 0; k < OT; ++k) v[p][k] = in ? acc[p][k] + bv[k] : 0.0f;
    if (in) {
      float4* yp = reinterpret_cast<float4*>(yr + (size_t)p * kC);
      yp[0] = make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
      yp[1] = make_float4(v[p][4], v[p][5], v[p][6], v[p][7]);
    }
  }
  float st[2][OT];  // [sum, sumsq][output o + k]: a pairwise tree over the run
#pragma unroll
  for (int k = 0; k < OT; ++k) {
    float s[PX], q[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      s[p] = v[p][k];
      q[p] = v[p][k] * v[p][k];
    }
#pragma unroll
    for (int n = PX / 2; n >= 1; n /= 2)
#pragma unroll
      for (int p = 0; p < n; ++p) {
        s[p] = s[2 * p] + s[2 * p + 1];
        q[p] = q[2 * p] + q[2 * p + 1];
      }
    st[0][k] = s[0];
    st[1][k] = q[0];
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2)
#pragma unroll
    for (int k = 0; k < 2 * OT; ++k)
      st[k / OT][k % OT] += __shfl_xor_sync(0xffffffffu, st[k / OT][k % OT], off);
  const int T = conv3f::tiles(H, W);
  float* pt = part + ((size_t)t.b * 2 * kC + t.o0) * T + t.ti;  // row (stat, ol): + (stat 64 + ol) T
  if (kWarps == 1) {
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 2 * OT; ++k)
        pt[((k / OT) * kC + th.o + k % OT) * (size_t)T] = st[k / OT][k % OT];
    return;
  }
  // the warps of a group in order, through the stage buffers (free once every
  // warp is past its last products)
  float* red = smem_f;  // [warp][stat][8]
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 2 * OT; ++k) red[threadIdx.x / 32 * 2 * OT + k] = st[k / OT][k % OT];
  __syncthreads();
  if (threadIdx.x < 2 * OG) {
    const int stat = threadIdx.x / OG, ol = threadIdx.x % OG;
    const float* r0 = red + (ol / OT * kWarps * 2 + stat) * OT + ol % OT;
    float sum = r0[0];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) sum += r0[j * 2 * OT];
    pt[(stat * kC + ol) * (size_t)T] = sum;
  }
}

template <int OG>
cudaError_t launch(const float* x, const float* w, const float* bias, const float* aff, float* y,
                   float* part, int B, int H, int W, int prologue, int grid, cudaStream_t s) {
  cudaError_t err = set_smem(conv3x3_stats_f32<OG>, conv3f::smem_bytes(OG));
  if (err != cudaSuccess) return err;
  conv3x3_stats_f32<OG><<<dim3((unsigned)grid), conv3f::kThreads, conv3f::smem_bytes(OG), s>>>(
      x, w, bias, aff, y, part, B, H, W, prologue, kC / OG);
  return cudaSuccess;
}
}  // namespace f32

}  // namespace

extern "C" {

// Shapes the kernel takes: x and y (B, 64, H, W), both contiguous NHWC in
// memory, i.e. torch.channels_last; w (64, 64, 3, 3) contiguous in x's dtype;
// bias (64,) and aff (B, 2, 64) [scale; shift] float32 (aff read only with
// prologue != 0); part (B, 2, 64, T) float32, T the rows of partial
// statistics per image, one per output tile: for bf16 ceil(H / 4) *
// ceil(W / 30), for float32 ceil(H / 8) * ceil(W / 32); a T that differs is
// refused. Pointers 16-byte aligned.
// dtype_code 0 = float32, 1 = bfloat16 (x, w, y).
// The launch, as kernels/block_cuda.py:pass_plan lays it out: tile_outputs,
// the outputs a block takes (bf16 64; float32 64, 32, 16 or 8, in 64 /
// tile_outputs groups); grid, the blocks (bf16 1 .. B * T persistent blocks,
// float32 one a (tile, output group)). Any other plan is refused.
int pips_conv3x3_stats(const void* x, const void* w, const void* bias, const void* aff, void* y,
                       void* part, int B, int H, int W, int T, int prologue, int dtype_code,
                       int tile_outputs, int grid, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (dtype_code != 0 && dtype_code != 1) ||
      T != (dtype_code == 1 ? tc::tiles(H, W) : conv3f::tiles(H, W)))
    return (int)cudaErrorInvalidValue;
  const long ntiles = (long)B * T;
  if (dtype_code == 1 ? (tile_outputs != kC || grid < 1 || grid > ntiles)
                      : ((tile_outputs != 64 && tile_outputs != 32 && tile_outputs != 16 &&
                          tile_outputs != 8) ||
                         grid != ntiles * (kC / tile_outputs)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(aff);
  float* pt = static_cast<float*>(part);
  if (dtype_code == 1) {
    // x and y as (64, W, H, B): 128-byte pixels, rows of W pixels, images
    const uint64_t dims[4] = {(uint64_t)kC, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {kC * 2, (uint64_t)W * kC * 2, (uint64_t)H * W * kC * 2};
    const uint32_t in_box[4] = {kC, tc::HC, tc::HR, 1};
    const uint32_t out_box[4] = {kC, tc::TW, tc::TH, 1};
    CUtensorMap x_map, y_map;
    err = make_map_bf16(&x_map, x, 4, dims, strides, in_box);
    if (err != cudaSuccess) return (int)err;
    err = make_map_bf16(&y_map, y, 4, dims, strides, out_box);
    if (err != cudaSuccess) return (int)err;
    err = set_smem(tc::conv3x3_stats_bf16, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    tc::conv3x3_stats_bf16<<<dim3((unsigned)grid), tc::kThreads, tc::kSmem, s>>>(
        x_map, y_map, static_cast<const bf16*>(w), bb, af, pt, B, H, W, prologue);
  } else {
    const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    err = tile_outputs == 64   ? f32::launch<64>(xf, wf, bb, af, yf, pt, B, H, W, prologue, grid, s)
          : tile_outputs == 32 ? f32::launch<32>(xf, wf, bb, af, yf, pt, B, H, W, prologue, grid, s)
          : tile_outputs == 16 ? f32::launch<16>(xf, wf, bb, af, yf, pt, B, H, W, prologue, grid, s)
                               : f32::launch<8>(xf, wf, bb, af, yf, pt, B, H, W, prologue, grid, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
