// 3x3, stride-1, SAME convolution with bias, NHWC (torch.channels_last) in and out:
//   y[b, o, h, w] = bias[o] + sum_{c, ky, kx} x[b, c, h+ky-1, w+kx-1] * w[o, c, ky, kx]
//
// Replaces the TPU kernel pips_tpu/kernels/conv_pallas.py:_conv3x3_pallas_raw
// (pallas_call of _conv3x3_kernel): the encoder's four 64->64 stage-1 convs
// under fuse_conv3, and the dx of their backward, which is this same kernel
// run on dy with the rotated, in/out-swapped weights.
//
// What bounds it on an H100: 2*576*64 operations per output pixel against
// 2*64*2 bytes (x read once, y written once, bf16). At 8x64x240x512 that is
// 72.5 GFLOP (0.073 ms at 989 TFLOP/s) against 251.7 MB (0.075 ms at
// 3.35 TB/s): the two bounds are level, so the kernel must both stream x and
// y at the memory rate and keep the tensor cores busy.
//
// Design. The TPU kernel packs a W-space-to-depth (1152, 128) weight with 50%
// structural zeros to fill 128 MXU lanes; Hopper has no lane width to fill,
// so this is the plain implicit GEMM: M = 64 outputs, N = output pixels,
// K = 9 taps x 64 channels = 576. Three kernels, one a call, by the path the
// wrapper's plan names (kernels/conv_cuda.py:launch_plan):
//   * bf16 with C = O = 64, every model call (conv3x3_wgmma): persistent
//     blocks, one an SM, walk output tiles of 4 rows x 30 columns. The haloed
//     input box of a tile, 6 x 32 pixels, is one TMA load into a six-slot
//     ring, fed by a producer warp. Three consumer warpgroups take the tiles
//     by turns, so that two run products while the third finishes a tile. A
//     tile is 36 wgmma m64n128k16 (one a (tap, 16 channels)) from the
//     resident weight and the box shifted by the tap: conv3x3_tiles.cuh's
//     mainloop, which conv3x3_stats.cu shares. Epilogue: the f32 bias added
//     to the f32 accumulator, one rounding to bf16 (as the TPU kernel does),
//     the tile staged by stmatrix (transposed to [pixel][o], swizzled as the
//     store's box) into its own ring slot, whose products are done, and
//     written by one TMA store, clipped at the image's edge. The slot goes
//     back to the producer once the store has read it, a wait that rides on
//     the warpgroup's next products.
//     Taller tiles read less halo (8 x 30 tiles: 1.33 input pixels an
//     output pixel, against 1.6 here) but measured slower on an H100
//     (tools/profile_pipelines.py's tile variants): their n256 or n192
//     accumulators need 128 or 96 registers a thread, and ptxas allots a
//     block of 288 or 416 threads registers as if it had 384 or 512, so the
//     kernel spills or runs on fewer warpgroups; the halo's second reads
//     come from L2.
//   * bf16 with other widths (multiples of 8 up to 64: conv3x3_bf16, the
//     first kernel): the weight resident, persistent blocks two an SM over
//     2 x 64 tiles, synchronous 16-byte loads into XOR-swizzled rows, four
//     warps on mma.sync m16n8k16 with ldmatrix, an epilogue staged through
//     the input tile.
//   * f32 (conv3x3_f32): f32 FMAs (mma.sync in f32 would be TF32, which
//     keeps 10 mantissa bits and would fail the f32 reference), bound by
//     the FMA rate: 2*576 FLOP per (pixel, output) at 67 TFLOP/s, 1.08 ms at
//     8x64x240x512, where x and y take 0.08 ms. conv3x3_f32_tiles.cuh's
//     mainloop, which conv3x3_stats.cu shares: 256 threads on an 8 x 32
//     pixel tile times 64, 32, 16 or 8 outputs (the plan splits the outputs
//     where the tiles alone would not fill the card), a run of 8, 4, 2 or 1
//     pixels x 8 outputs a thread, each input row loaded once for its three
//     column taps, channels in chunks of 8 through three cp.async stages.
//
// Plain C ABI (loaded with ctypes): pips_conv3x3_fwd returns
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

constexpr int kC = 64;  // channels per pixel row and outputs per tile (both zero-padded to 64)

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ----------------------------------------- bf16, C = O = 64 (wgmma, TMA ring)
namespace wg {
constexpr int TH = 4;                              // output tile rows
constexpr int TW = conv3::kBoxCols - 2;            // output tile columns: 30
constexpr int HR = TH + 2, HC = conv3::kBoxCols;   // the haloed box: 6 x 32 pixels
constexpr int kN = TH * HC;                        // 128: the products' N
constexpr int kWGs = 3;                            // consumer warpgroups, tiles by turns
constexpr int kStages = 6;                         // ring slots
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 32;          // and one producer warp
constexpr uint32_t kBoxBytes = HR * HC * 128;                       // 24,576: one TMA box
constexpr size_t kStageBytes = (kBoxBytes + 1023) / 1024 * 1024;    // 24,576
constexpr size_t kOutBytes = (size_t)TH * TW * 128;                 // 15,360: a tile's outputs
constexpr size_t kJunkBytes = 128;  // where the two columns past a row's outputs are stored
// 1024 bytes to align the tiles, the ring (a tile's outputs are staged in its
// own slot), the weight, the junk row, 2 * kStages mbarriers
constexpr size_t kSmem = 1024 + kStages * kStageBytes + conv3::kWBytes + kJunkBytes +
                         2 * kStages * 8;  // 222,432: one block an SM
static_assert(kStageBytes % 1024 == 0 && kOutBytes <= kStageBytes && kSmem <= 232448,
              "tiles 1024-byte aligned; a tile's outputs fit its slot; the block fits an SM");
static_assert(kStages > kWGs, "a warpgroup's next box lands while it holds its last slot");

// x_map / y_map: x and y as (64, W, H, B) bf16, boxes of (64, HC, HR, 1) and
// (64, TW, TH, 1), 128-byte swizzled
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma(__grid_constant__ const CUtensorMap x_map,
              __grid_constant__ const CUtensorMap y_map, const bf16* __restrict__ w,
              const float* __restrict__ bias, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ws = xs + kStages * kStageBytes;
  unsigned char* junk = ws + conv3::kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(junk + kJunkBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = ((H + TH - 1) / TH) * tiles_w;
  const int ntiles = B * per_image;
  // the block's tile i is tile blockIdx.x + i * gridDim.x, in ring slot
  // i % kStages; consumer warpgroup i % kWGs takes it
  auto tile_at = [&](int i, int& b, int& h0, int& w0) {
    const int t = blockIdx.x + i * gridDim.x;
    b = t / per_image;
    const int ti = t % per_image;
    h0 = ti / tiles_w * TH;
    w0 = (ti % tiles_w) * TW;
    return t < ntiles;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int b, h0, w0;
  if (warp == kConsumers / 32) {
    // the producer: each tile's haloed box by one TMA load (a 4D box; pixels
    // outside the image, the SAME padding, read as zero), into its slot once
    // the store of the outputs last staged there has read them
    if (lane == 0) {
      for (int i = 0; tile_at(i, b, h0, w0); ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kBoxBytes);
        tma_load_4d(xs + s * kStageBytes, &x_map, 0, w0 - 1, h0 - 1, b, &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, ctid = tid % 128;
  const int gq = lane / 4;
  // the weight, once a block, while the first boxes land: A of the products
  conv3::stage_weight(ws, w, tid, kConsumers);
  fence_proxy_async();  // the products read the weight through the async proxy
  named_sync(1, kConsumers);
  // this thread's outputs o1 = 16 wl + gq and o1 + 8 (accumulator rows)
  const int o1 = 16 * wl + gq;
  const float bias1 = bias[o1], bias2 = bias[o1 + 8];

  int prev = -1;  // the slot of this warpgroup's last tile, until its store has read it
  for (int i = wg; tile_at(i, b, h0, w0); i += kWGs) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    unsigned char* st = xs + s * kStageBytes;

    // y^T (64 outputs x 128 box pixels) = W^T X: per (tap, 16 channels) one
    // wgmma m64n128k16, all 36 issued at once (conv3x3_tiles.cuh)
    float acc[kN / 2];  // accumulator 4 n + 2 hi + e: output o1 + 8 hi, box pixel 8 n + 2 tq + e
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) acc[j] = 0.0f;
    wgmma_fence();
    conv3::products<kN>(acc, ws, st);
    wgmma_commit();
    // the last tile's slot goes back to the producer once its store has read
    // it: the wait rides on these products
    if (ctid == 0 && prev >= 0) {
      bulk_wait_read<0>();
      mbar_arrive(&empty[prev]);
    }
    wgmma_wait<0>();

    // epilogue: every warp's products from this box are done, so its slot
    // takes the outputs. Accumulator 4 n + 2 hi + e: output o1 + 8 hi, box
    // pixel 8 n + 2 tq + e (row n / 4, column 8 (n % 4) + 2 tq + e: an output
    // where the column is below TW; the store clips rows and columns past the
    // image). The f32 bias is added, the value rounded once, and staged
    // [pixel][o] swizzled as the store's box by stmatrix (transposed: a row
    // of the store is a pixel's 8 outputs); the two columns past a row's
    // outputs go to a junk row
    named_sync(2 + wg, 128);
#pragma unroll
    for (int n2 = 0; n2 < kN / 16; ++n2) {
      uint32_t r[4];  // matrices (n, hi): (2 n2, 0), (2 n2, 1), (2 n2 + 1, 0), (2 n2 + 1, 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 2 * n2 + k / 2, hi = k % 2;
        const float bo = hi ? bias2 : bias1;
        r[k] = bits(__floats2bfloat162_rn(acc[4 * n + 2 * hi] + bo, acc[4 * n + 2 * hi + 1] + bo));
      }
      // lane 8 k + j: row j of matrix k, pixel 8 n + j, outputs 16 wl + 8 hi ..
      const int k = lane / 8, n = 2 * n2 + k / 2, c = 8 * (n % 4) + lane % 8;
      unsigned char* dst = c < TW ? st + swz128((n / 4) * TW + c, 2 * wl + k % 2) : junk;
      stmatrix_x4_trans(dst, r[0], r[1], r[2], r[3]);
    }
    fence_proxy_async();  // the staged outputs are the TMA store's to read
    named_sync(2 + wg, 128);
    if (ctid == 0) {
      tma_store_4d(&y_map, st, 0, w0, h0, b);
      bulk_commit();
    }
    prev = s;
  }
  if (ctid == 0) bulk_wait<0>();  // the last stores are complete before the block ends
}
}  // namespace wg

// -------------------------------------------- bf16, other widths (mma.sync)
namespace tc {
constexpr int kThreads = 128;  // 4 warps, each 32 pixels x 64 outputs
constexpr int TH = 2;          // output tile rows
constexpr int TW = 64;         // output tile columns
constexpr int HR = TH + 2;     // haloed input rows: h0-1 .. h0+TH
constexpr int HC = TW + 2;     // haloed input columns: w0-1 .. w0+TW
constexpr int kPix = HR * HC;
constexpr int kWRows = 9 * kC;                          // weight rows [tap][o]
constexpr size_t kWBytes = (size_t)kWRows * kC * 2;     // 73,728
constexpr size_t kXBytes = (size_t)kPix * kC * 2;       // 33,792
constexpr int LDP = kC + 8;  // staged output: [pixel][o] row stride (16-byte rows)
constexpr size_t kSmem = kWBytes + kXBytes;             // 107,520: two blocks fit an SM
static_assert((size_t)TH * TW * LDP * 2 <= kXBytes, "the output stage must fit the input tile");
static_assert(kThreads / 32 * 32 == TH * TW, "each warp owns 32 output pixels");

// element offset of 16-byte chunk j (channels 8j..8j+7) of row r of a
// [rows][64] bf16 array whose chunks are XOR-swizzled by the row's low bits
__device__ __forceinline__ int swz(int r, int j) { return r * kC + ((j ^ (r & 7)) << 3); }

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* __restrict__ y, int B, int Cin, int H, int W,
             int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + kWBytes);
  bf16* os = xs;  // the output stage reuses the input tile once the MMAs are done

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the weight, once per block: row tap*64 + o holds w[o, :, ky, kx]; zeros
  // past Cout and past Cin
  for (int i = tid; i < kWRows * (kC / 8); i += kThreads) {
    const int q = i / (kC / 8), j = i % (kC / 8);
    const int tap = q / kC, o = q % kC;
    bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = j * 8 + k;
      v[k] = __float2bfloat16(0.0f);
      if (o < Cout && c < Cin) v[k] = w[((size_t)o * Cin + c) * 9 + tap];
    }
    *reinterpret_cast<uint4*>(ws + swz(q, j)) =
        make_uint4(bits(__halves2bfloat162(v[0], v[1])), bits(__halves2bfloat162(v[2], v[3])),
                   bits(__halves2bfloat162(v[4], v[5])), bits(__halves2bfloat162(v[6], v[7])));
  }

  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int ntiles = B * tiles_h * tiles_w;
  const size_t plane = (size_t)H * W;
  const int wr = warp / 2, wc = (warp % 2) * 32;  // this warp's tile row and first column

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * TH;
    const int w0 = (t % tiles_w) * TW;
    __syncthreads();  // weights stored / the previous tile's output written out

    // haloed input tile: each pixel's channels are contiguous, so item =
    // (pixel, 8-channel chunk) is one 16-byte load, consecutive threads on
    // consecutive chunks
    const bf16* xb = x + (size_t)b * plane * Cin;
    for (int i = tid; i < kPix * (kC / 8); i += kThreads) {
      const int p = i / (kC / 8), j = i % (kC / 8);
      const int h = h0 - 1 + p / HC, col = w0 - 1 + p % HC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (h >= 0 && h < H && col >= 0 && col < W && j * 8 < Cin)
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)h * W + col) * Cin + j * 8);
      *reinterpret_cast<uint4*>(xs + swz(p, j)) = v;
    }
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < kC / 16; ++kc) {
        // B: 64 outputs x 16 channels as eight n8 fragments, four ldmatrix.x4
        uint32_t bfr[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int o = np * 16 + (lane % 8) + (lane / 16) * 8;
          ldmatrix_x4(bfr[2 * np][0], bfr[2 * np][1], bfr[2 * np + 1][0], bfr[2 * np + 1][1],
                      ws + swz(tap * kC + o, kc * 2 + (lane / 8) % 2));
        }
        // A: 16 output pixels x 16 channels; output column c reads tile column c + kx
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          const int p = (wr + ky) * HC + wc + m * 16 + (lane % 16) + kx;
          ldmatrix_x4(a[0], a[1], a[2], a[3], xs + swz(p, kc * 2 + lane / 16));
#pragma unroll
          for (int n = 0; n < 8; ++n) mma_bf16(acc[m][n], a, bfr[n][0], bfr[n][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the input tile

    // accumulator (m, n): rows = pixels lane/4 and lane/4 + 8, columns =
    // outputs n*8 + 2*(lane%4) and + 1; bias in f32, then one rounding
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int o = n * 8 + (lane % 4) * 2;
      const float b0 = o < Cout ? bias[o] : 0.0f;
      const float b1 = o + 1 < Cout ? bias[o + 1] : 0.0f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int px = wr * TW + wc + m * 16 + lane / 4;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[m][n][0] + b0, acc[m][n][1] + b1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[m][n][2] + b0, acc[m][n][3] + b1);
        // stage [pixel][o]: the two outputs are one 4-byte word
        *reinterpret_cast<__nv_bfloat162*>(os + px * LDP + o) = lo;
        *reinterpret_cast<__nv_bfloat162*>(os + (px + 8) * LDP + o) = hi;
      }
    }
    __syncthreads();

    // write out: each pixel's outputs in 16-byte chunks (Cout % 8 == 0)
    bf16* yb = y + (size_t)b * plane * Cout;
    for (int i = tid; i < TH * TW * (Cout / 8); i += kThreads) {
      const int px = i / (Cout / 8), j = i % (Cout / 8);
      const int h = h0 + px / TW, col = w0 + px % TW;
      if (h < H && col < W)
        *reinterpret_cast<uint4*>(yb + ((size_t)h * W + col) * Cout + j * 8) =
            *reinterpret_cast<const uint4*>(os + px * LDP + j * 8);
    }
  }
}
}  // namespace tc

// ------------------------------------------- f32 (SIMT, register tiles)
namespace f32 {
// a block: an 8 x 32 pixel tile times OG outputs, on conv3x3_f32_tiles.cuh's
// mainloop; the f32 bias added to the f32 sums, each thread writing its
// pixels' 8 outputs as two float4 each (a 32-byte sector)
template <int OG>
__global__ void __launch_bounds__(conv3f::kThreads, 2)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y, int B, int Cin, int H, int W,
            int Cout, int groups) {
  constexpr int PX = conv3f::run(OG);
  extern __shared__ __align__(16) float smem_f[];
  const conv3f::Tile t = conv3f::tile_of(H, W, OG, groups);
  const conv3f::Thread<OG> th;
  float acc[PX][conv3f::OT];
  conv3f::mainloop<OG>(acc, th, smem_f, x, w, t, H, W, Cin, Cout, [](float*, int) {});

  const int o = t.o0 + th.o, h = t.h0 + th.r, c = t.w0 + th.c;
  if (o >= Cout || h >= H) return;  // Cout is a multiple of 8: a thread's outputs are all in or out
  const float4 b0 = *reinterpret_cast<const float4*>(bias + o);
  const float4 b1 = *reinterpret_cast<const float4*>(bias + o + 4);
  float* yr = y + (((size_t)t.b * H + h) * W + c) * Cout + o;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    if (c + p >= W) break;
    float4* yp = reinterpret_cast<float4*>(yr + (size_t)p * Cout);
    yp[0] = make_float4(acc[p][0] + b0.x, acc[p][1] + b0.y, acc[p][2] + b0.z, acc[p][3] + b0.w);
    yp[1] = make_float4(acc[p][4] + b1.x, acc[p][5] + b1.y, acc[p][6] + b1.z, acc[p][7] + b1.w);
  }
}

template <int OG>
cudaError_t launch(const float* x, const float* w, const float* bias, float* y, int B, int Cin,
                   int H, int W, int Cout, int groups, int grid, cudaStream_t s) {
  cudaError_t err = set_smem(conv3x3_f32<OG>, conv3f::smem_bytes(OG));
  if (err != cudaSuccess) return err;
  conv3x3_f32<OG><<<dim3((unsigned)grid), conv3f::kThreads, conv3f::smem_bytes(OG), s>>>(
      x, w, bias, y, B, Cin, H, W, Cout, groups);
  return cudaSuccess;
}
}  // namespace f32

}  // namespace

extern "C" {

// Shapes the kernels take: x (B, Cin, H, W) and y (B, Cout, H, W), both
// contiguous NHWC in memory, i.e. torch.channels_last; w (Cout, Cin, 3, 3)
// contiguous in x's dtype; bias (Cout,) float32; Cin and Cout multiples of 8
// from 8 to 64; pointers 16-byte aligned.
// dtype_code 0 = float32, 1 = bfloat16 (x, w, y).
// The launch, as kernels/conv_cuda.py:launch_plan lays it out: path 0 =
// conv3x3_f32 (float32), 1 = conv3x3_bf16 (bfloat16, other widths), 2 =
// conv3x3_wgmma (bfloat16, Cin = Cout = 64); tile_rows, the path's output
// tile rows (8, 2, 4); tile_outputs, the outputs a block takes (path 0: 64,
// 32, 16 or 8, in ceil(Cout / tile_outputs) groups; paths 1 and 2: 64);
// grid, the blocks: on path 0 one a (tile, output group), on paths 1 and 2
// 1 .. tiles persistent blocks. A plan that differs from what the kernels are
// compiled for is refused.
int pips_conv3x3_fwd(const void* x, const void* w, const void* bias, void* y, int B, int Cin,
                     int H, int W, int Cout, int dtype_code, int path, int tile_rows,
                     int tile_outputs, int grid, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin > kC || Cin % 8 || Cout <= 0 ||
      Cout > kC || Cout % 8 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  const int want = dtype_code == 0 ? 0 : (Cin == kC && Cout == kC ? 2 : 1);
  const int rows = path == 0 ? conv3f::TH : path == 1 ? tc::TH : wg::TH;
  const int cols = path == 0 ? conv3f::TW : path == 1 ? tc::TW : wg::TW;
  const long ntiles = (long)B * ((H + rows - 1) / rows) * ((W + cols - 1) / cols);
  const bool og_ok = path == 0 ? (tile_outputs == 64 || tile_outputs == 32 ||
                                  tile_outputs == 16 || tile_outputs == 8)
                               : tile_outputs == kC;
  if (path != want || tile_rows != rows || !og_ok || grid < 1 ||
      (path == 0 ? grid != ntiles * ((Cout + tile_outputs - 1) / tile_outputs) : grid > ntiles))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(bias);
  if (path == 2) {
    // x and y as (64, W, H, B): 128-byte pixels, rows of W pixels, images
    const uint64_t dims[4] = {(uint64_t)kC, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {kC * 2, (uint64_t)W * kC * 2, (uint64_t)H * W * kC * 2};
    const uint32_t in_box[4] = {kC, wg::HC, wg::HR, 1};
    const uint32_t out_box[4] = {kC, wg::TW, wg::TH, 1};
    CUtensorMap x_map, y_map;
    err = make_map_bf16(&x_map, x, 4, dims, strides, in_box);
    if (err != cudaSuccess) return (int)err;
    err = make_map_bf16(&y_map, y, 4, dims, strides, out_box);
    if (err != cudaSuccess) return (int)err;
    err = set_smem(wg::conv3x3_wgmma, wg::kSmem);
    if (err != cudaSuccess) return (int)err;
    wg::conv3x3_wgmma<<<dim3((unsigned)grid), wg::kThreads, wg::kSmem, s>>>(
        x_map, y_map, static_cast<const bf16*>(w), bb, B, H, W);
  } else if (path == 1) {
    err = set_smem(tc::conv3x3_bf16, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    tc::conv3x3_bf16<<<dim3((unsigned)grid), tc::kThreads, tc::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bb, static_cast<bf16*>(y), B,
        Cin, H, W, Cout);
  } else {
    const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    const int g = (Cout + tile_outputs - 1) / tile_outputs;
    err = tile_outputs == 64   ? f32::launch<64>(xf, wf, bb, yf, B, Cin, H, W, Cout, g, grid, s)
          : tile_outputs == 32 ? f32::launch<32>(xf, wf, bb, yf, B, Cin, H, W, Cout, g, grid, s)
          : tile_outputs == 16 ? f32::launch<16>(xf, wf, bb, yf, B, Cin, H, W, Cout, g, grid, s)
                               : f32::launch<8>(xf, wf, bb, yf, B, Cin, H, W, Cout, g, grid, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
