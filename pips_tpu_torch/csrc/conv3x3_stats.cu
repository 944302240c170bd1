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
// to fill, so this is conv3x3_fwd.cu's implicit GEMM (M = output pixels, N = 64
// outputs, K = 9 taps x 64 channels) with two additions:
//   * the prologue is applied in registers as each 16-byte chunk of the
//     haloed tile is loaded (four loads in flight per thread): only pixels
//     inside the image are loaded, the halo is zero-filled, so the padding
//     never sees the affine (a border reading relu(shift) would be the bug
//     to avoid);
//   * the statistics come from the f32 accumulators: each thread sums its
//     in-image pixels for its 16 output columns, warp shuffles sum over the
//     lanes that share a column, and the four warps' sums are added in a fixed
//     order into this tile's (sum, sumsq) row. Tiles never share a row, so no
//     atomics and the result is deterministic; the wrapper sums the tiles
//     (B, T, 2, 64) -> (B, 2, 64), as JAX sums its grid steps outside the
//     kernel.
// The weight (72 KB bf16) stays in shared memory; persistent blocks (two per
// SM) walk 2x64-pixel tiles; mma.sync m16n8k16 on ldmatrix fragments of
// XOR-swizzled pixel rows. f32 runs a SIMT kernel with f32 FMAs (mma.sync in
// f32 would be TF32), one output pixel per thread, its statistics reduced by
// a shuffle reduce-scatter over the warp.
//
// Plain C ABI (loaded with ctypes): pips_conv3x3_stats returns
// cudaGetLastError() after the launch; 0 means launched.
// pips_conv3x3_stats_tiles gives T, the tiles per image of the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------ bf16 (mma.sync)
namespace tc {
constexpr int kThreads = 128;  // 4 warps, each 32 pixels x 64 outputs
constexpr int kWarps = kThreads / 32;
constexpr int TH = 2;          // output tile rows
constexpr int TW = 64;         // output tile columns
constexpr int HR = TH + 2;     // haloed input rows: h0-1 .. h0+TH
constexpr int HC = TW + 2;     // haloed input columns: w0-1 .. w0+TW
constexpr int kPix = HR * HC;
constexpr int kWRows = 9 * kC;                          // weight rows [tap][o]
constexpr size_t kWBytes = (size_t)kWRows * kC * 2;     // 73,728
constexpr size_t kXBytes = (size_t)kPix * kC * 2;       // 33,792
constexpr size_t kSBytes = (size_t)kWarps * 2 * kC * 4;  // 2,048: per-warp (sum, sumsq)
constexpr int LDP = kC + 8;  // staged output: [pixel][o] row stride (16-byte rows)
constexpr size_t kSmem = kWBytes + kXBytes + kSBytes;   // 109,568: two blocks fit an SM
static_assert((size_t)TH * TW * LDP * 2 <= kXBytes, "the output stage must fit the input tile");
static_assert(kWarps * 32 == TH * TW, "each warp owns 32 output pixels");

__host__ __device__ constexpr int tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// element offset of 16-byte chunk j (channels 8j..8j+7) of row r of a
// [rows][64] bf16 array whose chunks are XOR-swizzled by the row's low bits
__device__ __forceinline__ int swz(int r, int j) { return r * kC + ((j ^ (r & 7)) << 3); }

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_stats_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ aff,
                   bf16* __restrict__ y, float* __restrict__ part, int B, int H, int W,
                   int prologue) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + kWBytes);
  bf16* os = xs;  // the output stage reuses the input tile once the MMAs are done
  float* ss = reinterpret_cast<float*>(smem + kWBytes + kXBytes);  // [warp][2][o]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the weight, once per block: row tap*64 + o holds w[o, :, ky, kx]
  for (int i = tid; i < kWRows * (kC / 8); i += kThreads) {
    const int q = i / (kC / 8), j = i % (kC / 8);
    const int tap = q / kC, o = q % kC;
    bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = w[((size_t)o * kC + j * 8 + k) * 9 + tap];
    *reinterpret_cast<uint4*>(ws + swz(q, j)) =
        make_uint4(bits(__halves2bfloat162(v[0], v[1])), bits(__halves2bfloat162(v[2], v[3])),
                   bits(__halves2bfloat162(v[4], v[5])), bits(__halves2bfloat162(v[6], v[7])));
  }

  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = tiles(H, W);
  const int ntiles = B * per_image;
  const size_t plane = (size_t)H * W;
  const int wr = warp / 2, wc = (warp % 2) * 32;  // this warp's tile row and first column

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / per_image, ti = t % per_image;
    const int h0 = ti / tiles_w * TH;
    const int w0 = (ti % tiles_w) * TW;
    __syncthreads();  // weights stored / the previous tile's output and stats written out

    // haloed input tile: item = (pixel, 8-channel chunk), one 16-byte load,
    // four in flight per thread; pixels outside the image stay zero, with or
    // without the prologue. A thread's chunk index is tid % 8 for every item
    // (the stride is a multiple of 8), so its eight channels' scale and shift
    // are loaded once per tile
    const bf16* xb = x + (size_t)b * plane * kC;
    const int jc = tid % (kC / 8);
    float sc[8], sh[8];
    if (prologue) {
      const float4* a4 = reinterpret_cast<const float4*>(aff + (size_t)b * 2 * kC + jc * 8);
      const float4 a0 = a4[0], a1 = a4[1], c0 = a4[kC / 4], c1 = a4[kC / 4 + 1];
      const float s8[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float t8[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sc[k] = s8[k];
        sh[k] = t8[k];
      }
    }
    constexpr int kChunks = kPix * (kC / 8);
    constexpr int kBatch = 4;
#pragma unroll 1
    for (int i0 = tid; i0 < kChunks; i0 += kBatch * kThreads) {
      uint4 v[kBatch];
      bool inside[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = (i0 + u * kThreads) / (kC / 8);
        const int h = h0 - 1 + p / HC, col = w0 - 1 + p % HC;
        inside[u] = p < kPix && h >= 0 && h < H && col >= 0 && col < W;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (inside[u])
          v[u] = *reinterpret_cast<const uint4*>(xb + ((size_t)h * W + col) * kC + jc * 8);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = (i0 + u * kThreads) / (kC / 8);
        if (p >= kPix) continue;
        if (prologue && inside[u]) {
          __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(pr[k]);
            pr[k] = __floats2bfloat162_rn(affine_relu(f.x, sc[2 * k], sh[2 * k]),
                                          affine_relu(f.y, sc[2 * k + 1], sh[2 * k + 1]));
          }
        }
        *reinterpret_cast<uint4*>(xs + swz(p, jc)) = v[u];
      }
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
        uint32_t bfr[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int o = np * 16 + (lane % 8) + (lane / 16) * 8;
          ldmatrix_x4(bfr[2 * np][0], bfr[2 * np][1], bfr[2 * np + 1][0], bfr[2 * np + 1][1],
                      ws + swz(tap * kC + o, kc * 2 + (lane / 8) % 2));
        }
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

    // accumulator (m, n): rows = pixels lane/4 and lane/4 + 8 of the warp's
    // 16-pixel group m, columns = outputs n*8 + 2*(lane%4) and + 1. Add the
    // f32 bias; sum this thread's in-image pixels for its 16 columns
    const bool row_in = h0 + wr < H;
    const int col0 = w0 + wc + lane / 4;
    bool in[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      in[m][0] = row_in && col0 + m * 16 < W;
      in[m][1] = row_in && col0 + m * 16 + 8 < W;
    }
    float s[8][2], q[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int o = n * 8 + (lane % 4) * 2;
      const float bo[2] = {bias[o], bias[o + 1]};
#pragma unroll
      for (int k = 0; k < 2; ++k) s[n][k] = q[n][k] = 0.0f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = acc[m][n][e] + bo[e % 2];
          acc[m][n][e] = v;
          if (in[m][e / 2]) {
            s[n][e % 2] += v;
            q[n][e % 2] += v * v;
          }
        }
    }
    // over the eight lanes that share lane%4 (xor 4, 8, 16)
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          s[n][k] += __shfl_xor_sync(0xffffffffu, s[n][k], off);
          q[n][k] += __shfl_xor_sync(0xffffffffu, q[n][k], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int o = n * 8 + lane * 2 + k;
          ss[(warp * 2 + 0) * kC + o] = s[n][k];
          ss[(warp * 2 + 1) * kC + o] = q[n][k];
        }
    }
    __syncthreads();  // every warp is done with the input tile; its stats are in ss

    // stage [pixel][o], one rounding of the biased f32 value
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int o = n * 8 + (lane % 4) * 2;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int px = wr * TW + wc + m * 16 + lane / 4;
        *reinterpret_cast<__nv_bfloat162*>(os + px * LDP + o) =
            __floats2bfloat162_rn(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<__nv_bfloat162*>(os + (px + 8) * LDP + o) =
            __floats2bfloat162_rn(acc[m][n][2], acc[m][n][3]);
      }
    }
    // this tile's (sum, sumsq): the warps added in a fixed order
    if (tid < 2 * kC) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += ss[(k * 2 + tid / kC) * kC + tid % kC];
      part[((size_t)b * per_image + ti) * 2 * kC + tid] = v;
    }
    __syncthreads();

    bf16* yb = y + (size_t)b * plane * kC;
    for (int i = tid; i < TH * TW * (kC / 8); i += kThreads) {
      const int px = i / (kC / 8), j = i % (kC / 8);
      const int h = h0 + px / TW, col = w0 + px % TW;
      if (h < H && col < W)
        *reinterpret_cast<uint4*>(yb + ((size_t)h * W + col) * kC + j * 8) =
            *reinterpret_cast<const uint4*>(os + px * LDP + j * 8);
    }
  }
}
}  // namespace tc

// ------------------------------------------------------------------ f32 (SIMT)
namespace simt {
constexpr int kThreads = 256;  // one output pixel per thread, all 64 outputs in registers
constexpr int kWarps = kThreads / 32;
constexpr int TH = 8, TW = 32;
constexpr int CC = 8;          // input channels staged per step
constexpr int HR = TH + 2, HC = TW + 2;
constexpr size_t kXBytes = (size_t)CC * HR * HC * 4;  // 10,880
constexpr size_t kWBytes = (size_t)CC * 9 * kC * 4;   // 18,432
constexpr size_t kSBytes = (size_t)kWarps * 2 * kC * 4;  // 4,096
constexpr size_t kSmem = kXBytes + kWBytes + kSBytes;
static_assert(TH * TW == kThreads && kXBytes % 16 == 0 && kWBytes % 16 == 0, "thread map");

__host__ __device__ constexpr int tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_stats_f32(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ aff,
                  float* __restrict__ y, float* __restrict__ part, int B, int H, int W,
                  int prologue) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                       // [CC][HR][HC]
  float* ws = reinterpret_cast<float*>(smem + kXBytes);             // [CC][tap][kC]
  float* ss = reinterpret_cast<float*>(smem + kXBytes + kWBytes);   // [warp][2][o]

  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = tiles(H, W);
  const int t = blockIdx.x;
  const int b = t / per_image, ti = t % per_image;
  const int h0 = ti / tiles_w * TH, w0 = (ti % tiles_w) * TW;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)H * W;
  const float* xb = x + (size_t)b * plane * kC;
  const float* scale = aff + (size_t)b * 2 * kC;
  const float* shift = scale + kC;

  float acc[kC];
#pragma unroll
  for (int o = 0; o < kC; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < kC; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < CC * HR * HC; i += kThreads) {
      const int k = i % CC, p = i / CC, r = p / HC, cc = p % HC;
      const int c = c0 + k, h = h0 - 1 + r, col = w0 - 1 + cc;
      float v = 0.0f;  // the SAME padding, with or without the prologue
      if (h >= 0 && h < H && col >= 0 && col < W) {
        v = xb[((size_t)h * W + col) * kC + c];
        if (prologue) v = affine_relu(v, scale[c], shift[c]);
      }
      xs[k * HR * HC + p] = v;
    }
    for (int i = threadIdx.x; i < CC * 9 * kC; i += kThreads) {
      const int c = c0 + i / (9 * kC), tap = (i / kC) % 9, o = i % kC;
      ws[i] = w[((size_t)o * kC + c) * 9 + tap];
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
  const bool in = h < H && col < W;
#pragma unroll
  for (int o = 0; o < kC; ++o) acc[o] += bias[o];
  if (in) {
    float* yb = y + ((size_t)b * plane + (size_t)h * W + col) * kC;
#pragma unroll
    for (int o = 0; o < kC; o += 4)
      *reinterpret_cast<float4*>(yb + o) = make_float4(acc[o], acc[o + 1], acc[o + 2], acc[o + 3]);
  }

  // statistics: a reduce-scatter over the warp's lanes. Each step halves
  // the values a lane holds: it keeps the half its lane bit selects and adds
  // the partner's copy of that half, so lane l ends with the warp's sums for
  // outputs 2l and 2l+1
  float* s = acc;  // the pixel's values, zero outside the image
  float q[kC];
#pragma unroll
  for (int o = 0; o < kC; ++o) {
    s[o] = in ? acc[o] : 0.0f;
    q[o] = s[o] * s[o];
  }
#pragma unroll
  for (int half = kC / 2; half >= 2; half /= 2) {
    const int off = half / 2;  // lane bit 16 for half 32, ..., bit 1 for half 2
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float ks = upper ? s[i + half] : s[i], gs = upper ? s[i] : s[i + half];
      const float kq = upper ? q[i + half] : q[i], gq = upper ? q[i] : q[i + half];
      s[i] = ks + __shfl_xor_sync(0xffffffffu, gs, off);
      q[i] = kq + __shfl_xor_sync(0xffffffffu, gq, off);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    ss[(warp * 2 + 0) * kC + 2 * lane + k] = s[k];
    ss[(warp * 2 + 1) * kC + 2 * lane + k] = q[k];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += ss[(k * 2 + threadIdx.x / kC) * kC + threadIdx.x % kC];
    part[((size_t)b * per_image + ti) * 2 * kC + threadIdx.x] = v;
  }
}
}  // namespace simt

}  // namespace

extern "C" {

// Tiles per image T of the partial statistics (B, T, 2, 64) for this dtype.
int pips_conv3x3_stats_tiles(int H, int W, int dtype_code) {
  return dtype_code == 1 ? tc::tiles(H, W) : simt::tiles(H, W);
}

// Shapes the kernel takes: x and y (B, 64, H, W), both contiguous NHWC in
// memory, i.e. torch.channels_last; w (64, 64, 3, 3) contiguous in x's dtype;
// bias (64,) and aff (B, 2, 64) [scale; shift] float32 (aff read only with
// prologue != 0); part (B, T, 2, 64) float32 with T from
// pips_conv3x3_stats_tiles; pointers 16-byte aligned.
// dtype_code 0 = float32, 1 = bfloat16 (x, w, y).
int pips_conv3x3_stats(const void* x, const void* w, const void* bias, const void* aff, void* y,
                       void* part, int B, int H, int W, int prologue, int dtype_code, int device,
                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(aff);
  float* pt = static_cast<float*>(part);
  if (dtype_code == 1) {
    err = set_smem(tc::conv3x3_stats_bf16, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc::conv3x3_stats_bf16,
                                                        tc::kThreads, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    const long ntiles = (long)B * tc::tiles(H, W);
    const long resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
    const dim3 grid((unsigned)(ntiles < resident ? ntiles : resident));
    tc::conv3x3_stats_bf16<<<grid, tc::kThreads, tc::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bb, af, static_cast<bf16*>(y),
        pt, B, H, W, prologue);
  } else {
    err = set_smem(simt::conv3x3_stats_f32, simt::kSmem);
    if (err != cudaSuccess) return (int)err;
    const long ntiles = (long)B * simt::tiles(H, W);
    simt::conv3x3_stats_f32<<<dim3((unsigned)ntiles), simt::kThreads, simt::kSmem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bb, af,
        static_cast<float*>(y), pt, B, H, W, prologue);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
