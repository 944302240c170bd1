// Fused MLP-Mixer channel block, forward only:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the TPU kernel pips_tpu/kernels/mixer_pallas.py:_chanff_fwd
// (pallas_call of _chanff_fwd_kernel). x is (R, D) rows, R = B*N*S; the PIPs
// delta block runs it 12 times per refinement iteration at D=512, F=2048.
//
// What bounds it on an H100: 4*R*D*F operations against ~R*D*4 + 2*D*F*2
// bytes. At R=2048 that is 8.6 GFLOP (8.7 us at 989 TFLOP/s bf16) against
// ~8 MB (2.5 us at 3.35 TB/s), so from a few hundred rows up it is bound by
// the tensor cores, not by memory.
//
// Design. The TPU kernel keeps w1 and w2 (2 MB each in bf16) resident in
// VMEM across row tiles; they do not fit the 227 KB of shared memory a block
// may use. Instead each block owns TR rows and walks F in chunks of FC:
//   1. LayerNorm its TR rows into shared memory (f32 statistics, compute dtype);
//   2. per chunk, stage w1[:, f:f+FC] and w2[f:f+FC, :] in shared memory,
//      compute the (TR, FC) pre-activation, add b1, apply GELU, and add its
//      product with the w2 chunk into a (TR, D) f32 accumulator held in
//      registers, so no intermediate goes to device memory;
//   3. epilogue: b2, residual in f32, cast, store.
// Ragged R is masked in the kernel (rows past R are zero in shared memory
// and never stored). bf16 runs on the tensor cores through WMMA with f32
// accumulation; f32 runs on SIMT FMAs, so it keeps full f32 products as the
// reference does (TF32 would not). wgmma/TMA pipelining is later work.
//
// Numerics follow chan_ff_reference: LN statistics in f32 with
// var = E[x^2] - mu^2 clamped at 0, eps 1e-5; both matmuls take the compute
// dtype and accumulate in f32; exact-erf GELU in f32. CUDA's erff stands in
// for the rational erf the TPU kernel uses (XLA's ErfImpl32); the two differ
// by a few f32 ulps, far below bf16 resolution.
//
// Plain C ABI (loaded with ctypes): pips_chanff_fwd returns cudaGetLastError()
// after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "chanff_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 32;        // rows per block

// ---------------------------------------------------------------- bf16 (WMMA)
namespace tc {
constexpr int FC = 64;          // F chunk
constexpr int LDA = kD + 8;     // xa / w2 chunk row stride (bf16), padded against bank conflicts
constexpr int LDW1 = FC + 8;    // w1 chunk / gelu tile row stride (bf16)
constexpr int LDH = FC + 4;     // f32 pre-activation tile row stride
constexpr int LDC = kD + 4;     // f32 accumulator tile row stride (epilogue)
constexpr size_t kXa = (size_t)kTR * LDA * 2;
constexpr size_t kW1 = (size_t)kD * LDW1 * 2;
constexpr size_t kW2 = (size_t)FC * LDA * 2;
constexpr size_t kHf = (size_t)kTR * LDH * 4;
constexpr size_t kHb = (size_t)kTR * LDW1 * 2;
constexpr size_t kSmem = kXa + kW1 + kW2 + kHf + kHb;
static_assert((size_t)kTR * LDC * 4 <= kW1 + kW2, "epilogue tile must fit the weight buffers");
static_assert((kTR / 16) * (FC / 16) == kWarps, "one fc1 tile per warp");
static_assert(kD % (16 * kWarps) == 0, "fc2 columns split evenly over warps");
constexpr int kAccRows = kTR / 16;            // 16x16 accumulator tiles per warp, rows
constexpr int kAccCols = kD / (16 * kWarps);  // and columns

__global__ void __launch_bounds__(kThreads)
chanff_fwd_bf16(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ y, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* w1c = reinterpret_cast<bf16*>(smem + kXa);
  bf16* w2c = reinterpret_cast<bf16*>(smem + kXa + kW1);
  float* hf = reinterpret_cast<float*>(smem + kXa + kW1 + kW2);
  bf16* hb = reinterpret_cast<bf16*>(smem + kXa + kW1 + kW2 + kHf);
  float* acc_tile = reinterpret_cast<float*>(smem + kXa);  // reuses w1c/w2c after the loop

  const int row0 = blockIdx.x * kTR;
  const int warp = threadIdx.x / 32;
  ln_rows<kTR>(x, ln_scale, ln_bias, xa, LDA, row0, R);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kAccRows][kAccCols];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int h_r = (warp / (FC / 16)) * 16;  // this warp's fc1 tile
  const int h_c = (warp % (FC / 16)) * 16;
  const int col0 = warp * kAccCols * 16;    // this warp's fc2 columns

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // LN rows written / previous chunk fully consumed
    for (int i = threadIdx.x; i < kD * FC / 8; i += kThreads) {
      const int r = i / (FC / 8), c = (i % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1c + r * LDW1 + c) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)r * F + f0 + c);
    }
    for (int i = threadIdx.x; i < FC * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      *reinterpret_cast<uint4*>(w2c + r * LDA + c) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)(f0 + r) * kD + c);
    }
    __syncthreads();

    {  // fc1: (kTR, FC) pre-activation, one 16x16 tile per warp
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
      wmma::fill_fragment(h, 0.0f);
#pragma unroll 4
      for (int k = 0; k < kD; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xa + h_r * LDA + k, LDA);
        wmma::load_matrix_sync(b, w1c + k * LDW1 + h_c, LDW1);
        wmma::mma_sync(h, a, b, h);
      }
      wmma::store_matrix_sync(hf + h_r * LDH + h_c, h, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTR * FC; i += kThreads) {
      const int r = i / FC, c = i % FC;
      hb[r * LDW1 + c] = __float2bfloat16(gelu(hf[r * LDH + c] + b1[f0 + c]));
    }
    __syncthreads();

    // fc2: acc += gelu tile (kTR, FC) @ w2 chunk (FC, kD)
#pragma unroll
    for (int k = 0; k < FC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kAccRows];
#pragma unroll
      for (int i = 0; i < kAccRows; ++i)
        wmma::load_matrix_sync(a[i], hb + (i * 16) * LDW1 + k, LDW1);
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w2c + k * LDA + col0 + j * 16, LDA);
#pragma unroll
        for (int i = 0; i < kAccRows; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with w1c/w2c before acc_tile overwrites them
#pragma unroll
  for (int i = 0; i < kAccRows; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j)
      wmma::store_matrix_sync(acc_tile + (i * 16) * LDC + col0 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTR * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    if (row < R) {
      const size_t o = (size_t)row * kD + c;
      y[o] = __float2bfloat16(__bfloat162float(x[o]) + (acc_tile[r * LDC + c] + b2[c]));
    }
  }
}
}  // namespace tc

// ------------------------------------------------------------------ f32 (SIMT)
namespace simt {
constexpr int FC = 32;
constexpr size_t kXa = (size_t)kTR * kD * 4;
constexpr size_t kW1 = (size_t)kD * FC * 4;
constexpr size_t kW2 = (size_t)FC * kD * 4;
constexpr size_t kH = (size_t)kTR * FC * 4;
constexpr size_t kSmem = kXa + kW1 + kW2 + kH;
// fc1: warp w computes rows [4w, 4w+4) x all FC columns (lane = column)
static_assert(kWarps * 4 == kTR && FC == 32, "fc1 thread map");
// fc2: thread t owns rows [16*(t/128), +16) x columns [4*(t%128), +4)
constexpr int kRowsPerThread = 16;
static_assert((kThreads / 128) * kRowsPerThread == kTR && 128 * 4 == kD, "fc2 thread map");

__global__ void __launch_bounds__(kThreads)
chanff_fwd_f32(const float* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ y, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xa = reinterpret_cast<float*>(smem);
  float* w1c = reinterpret_cast<float*>(smem + kXa);
  float* w2c = reinterpret_cast<float*>(smem + kXa + kW1);
  float* hs = reinterpret_cast<float*>(smem + kXa + kW1 + kW2);

  const int row0 = blockIdx.x * kTR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ln_rows<kTR>(x, ln_scale, ln_bias, xa, kD, row0, R);

  const int ar = (threadIdx.x / 128) * kRowsPerThread;
  const int ac = (threadIdx.x % 128) * 4;
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kD * FC / 4; i += kThreads) {
      const int r = i / (FC / 4), c = (i % (FC / 4)) * 4;
      *reinterpret_cast<float4*>(w1c + r * FC + c) =
          *reinterpret_cast<const float4*>(w1 + (size_t)r * F + f0 + c);
    }
    for (int i = threadIdx.x; i < FC * kD / 4; i += kThreads) {
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      *reinterpret_cast<float4*>(w2c + r * kD + c) =
          *reinterpret_cast<const float4*>(w2 + (size_t)(f0 + r) * kD + c);
    }
    __syncthreads();

    {  // fc1 + b1 + GELU into hs
      float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < kD; ++k) {
        const float w = w1c[k * FC + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = fmaf(xa[(warp * 4 + i) * kD + k], w, h[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) hs[(warp * 4 + i) * FC + lane] = gelu(h[i] + b1[f0 + lane]);
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < FC; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(w2c + k * kD + ac);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float g = hs[(ar + i) * FC + k];
        acc[i][0] = fmaf(g, w.x, acc[i][0]);
        acc[i][1] = fmaf(g, w.y, acc[i][1]);
        acc[i][2] = fmaf(g, w.z, acc[i][2]);
        acc[i][3] = fmaf(g, w.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ar + i;
    if (row < R) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t o = (size_t)row * kD + ac + j;
        y[o] = x[o] + (acc[i][j] + b2[ac + j]);
      }
    }
  }
}
}  // namespace simt

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Shapes the kernel takes: D == 512; F a multiple of 64; R >= 1. All pointers
// 16-byte aligned and contiguous. dtype_code 0 = float32, 1 = bfloat16 (x,
// w1, w2, y); ln_scale, ln_bias, b1, b2 are float32.
int pips_chanff_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* y, int R, int D,
                    int F, int dtype_code, int device, void* stream) {
  if (D != kD || F <= 0 || F % tc::FC != 0 || R <= 0 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTR - 1) / kTR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* b = static_cast<const float*>(ln_bias);
  const float* bb1 = static_cast<const float*>(b1);
  const float* bb2 = static_cast<const float*>(b2);
  if (dtype_code == 1) {
    err = set_smem(tc::chanff_fwd_bf16, tc::kSmem);
    if (err != cudaSuccess) return (int)err;
    tc::chanff_fwd_bf16<<<grid, kThreads, tc::kSmem, s>>>(
        static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(w1), bb1,
        static_cast<const bf16*>(w2), bb2, static_cast<bf16*>(y), R, F);
  } else {
    err = set_smem(simt::chanff_fwd_f32, simt::kSmem);
    if (err != cudaSuccess) return (int)err;
    simt::chanff_fwd_f32<<<grid, kThreads, simt::kSmem, s>>>(
        static_cast<const float*>(x), g, b, static_cast<const float*>(w1), bb1,
        static_cast<const float*>(w2), bb2, static_cast<float*>(y), R, F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
