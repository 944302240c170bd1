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
// so this is the plain implicit GEMM: M = output pixels, N = 64 outputs,
// K = 9 taps x 64 channels = 576.
//   * The whole weight (9x64x64 bf16 = 72 KB) stays in shared memory. Blocks
//     are persistent (two per SM) and load it once, then walk output tiles of
//     2 rows x 64 columns; while one block loads a tile the other computes.
//   * NHWC is read in place, no permute: the port's encoder runs
//     channels_last (Pips.encode permutes (B*S, H, W, 3) frames, and cuDNN
//     keeps that format through every conv), where a pixel's 64 channels are
//     one 128-byte row: each 16-byte chunk is one load straight into a
//     pixel-major row in shared memory, and the output leaves the same way.
//     Rows are XOR-swizzled by 16-byte chunk, so the ldmatrix reads below are
//     free of bank conflicts without padding (which keeps two blocks per SM).
//   * Tap (ky, kx) of a run of 16 output pixels is a run of 16 consecutive
//     pixel rows of the tile, so each (tap, 16-channel step) is one ldmatrix
//     of A per 16 pixels; each warp owns 32 pixels x 64 outputs and runs
//     mma.sync m16n8k16 (bf16 in, f32 accumulators) over K = 576.
//   * Epilogue: the f32 bias is added to the f32 accumulator before the one
//     rounding (as the TPU kernel does); the tile is staged in shared memory
//     as [pixel][o] and written out in 16-byte chunks.
// f32 runs a SIMT kernel with f32 FMAs (mma.sync in f32 would be TF32, which
// keeps 10 mantissa bits and would fail the f32 reference). wgmma, TMA and a
// double-buffered tile are later work.
//
// Plain C ABI (loaded with ctypes): pips_conv3x3_fwd returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;  // channels per pixel row and outputs per tile (both zero-padded to 64)

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ------------------------------------------------------------ bf16 (mma.sync)
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

// ------------------------------------------------------------------ f32 (SIMT)
namespace simt {
constexpr int kThreads = 256;  // one output pixel per thread, all 64 outputs in registers
constexpr int TH = 8, TW = 32;
constexpr int CC = 8;          // input channels staged per step
constexpr int HR = TH + 2, HC = TW + 2;
constexpr size_t kXBytes = (size_t)CC * HR * HC * 4;  // 10,880
constexpr size_t kWBytes = (size_t)CC * 9 * kC * 4;   // 18,432
constexpr size_t kSmem = kXBytes + kWBytes;
static_assert(TH * TW == kThreads && kXBytes % 16 == 0, "thread map / alignment");

__global__ void __launch_bounds__(kThreads)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y, int B, int Cin, int H, int W,
            int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);            // [CC][HR][HC]
  float* ws = reinterpret_cast<float*>(smem + kXBytes);  // [CC][tap][kC], zeros past Cout

  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int t = blockIdx.x;
  const int b = t / (tiles_h * tiles_w);
  const int h0 = (t / tiles_w) % tiles_h * TH, w0 = (t % tiles_w) * TW;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const size_t plane = (size_t)H * W;
  const float* xb = x + (size_t)b * plane * Cin;

  float acc[kC];
#pragma unroll
  for (int o = 0; o < kC; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
    // channel fastest, so eight threads read one pixel's 32 contiguous bytes
    for (int i = threadIdx.x; i < CC * HR * HC; i += kThreads) {
      const int k = i % CC, p = i / CC, r = p / HC, cc = p % HC;
      const int c = c0 + k, h = h0 - 1 + r, col = w0 - 1 + cc;
      xs[k * HR * HC + p] = (c < Cin && h >= 0 && h < H && col >= 0 && col < W)
                                ? xb[((size_t)h * W + col) * Cin + c]
                                : 0.0f;
    }
    for (int i = threadIdx.x; i < CC * 9 * kC; i += kThreads) {
      const int c = c0 + i / (9 * kC), tap = (i / kC) % 9, o = i % kC;
      ws[i] = (c < Cin && o < Cout) ? w[((size_t)o * Cin + c) * 9 + tap] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < CC; ++c) {
      for (int tap = 0; tap < 9; ++tap) {
        const float v = xs[(c * HR + ty + tap / 3) * HC + tx + tap % 3];
        const float4* wq = reinterpret_cast<const float4*>(ws + (c * 9 + tap) * kC);
#pragma unroll
        for (int o4 = 0; o4 < kC / 4; ++o4) {
          const float4 q = wq[o4];  // the same address for every thread: a broadcast
          acc[4 * o4 + 0] = fmaf(v, q.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(v, q.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(v, q.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(v, q.w, acc[4 * o4 + 3]);
        }
      }
    }
  }

  const int h = h0 + ty, col = w0 + tx;
  if (h < H && col < W) {
    float* yb = y + ((size_t)b * plane + (size_t)h * W + col) * Cout;
#pragma unroll
    for (int o = 0; o < kC; ++o)
      if (o < Cout) yb[o] = acc[o] + bias[o];
  }
}
}  // namespace simt

}  // namespace

extern "C" {

// Shapes the kernel takes: x (B, Cin, H, W) and y (B, Cout, H, W), both
// contiguous NHWC in memory, i.e. torch.channels_last; w (Cout, Cin, 3, 3)
// contiguous in x's dtype; bias (Cout,) float32; Cin and Cout multiples of 8
// from 8 to 64; pointers 16-byte aligned.
// dtype_code 0 = float32, 1 = bfloat16 (x, w, y).
int pips_conv3x3_fwd(const void* x, const void* w, const void* bias, void* y, int B, int Cin,
                     int H, int W, int Cout, int dtype_code, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin > kC || Cin % 8 || Cout <= 0 ||
      Cout > kC || Cout % 8 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(bias);
  if (dtype_code == 1) {
    err = set_smem(tc::conv3x3_bf16, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc::conv3x3_bf16, tc::kThreads,
                                                        tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    const long ntiles = (long)B * ((H + tc::TH - 1) / tc::TH) * ((W + tc::TW - 1) / tc::TW);
    const long resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
    const dim3 grid((unsigned)(ntiles < resident ? ntiles : resident));
    tc::conv3x3_bf16<<<grid, tc::kThreads, tc::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bb, static_cast<bf16*>(y), B,
        Cin, H, W, Cout);
  } else {
    err = set_smem(simt::conv3x3_f32, simt::kSmem);
    if (err != cudaSuccess) return (int)err;
    const long ntiles =
        (long)B * ((H + simt::TH - 1) / simt::TH) * ((W + simt::TW - 1) / simt::TW);
    simt::conv3x3_f32<<<dim3((unsigned)ntiles), simt::kThreads, simt::kSmem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bb, static_cast<float*>(y),
        B, Cin, H, W, Cout);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
