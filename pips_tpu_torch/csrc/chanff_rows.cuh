// Row-wise device code shared by the channel-block kernels (chanff_fwd.cu,
// chanff_bwd.cu, chanff_chunk.cu), in the compute dtype T (float or bf16):
// the LayerNorm of a block's rows, GELU and its derivative, the LN backward,
// and the per-block column partials that chanff_bwd.cu's column sums add.
//
// Numerics (those of chan_ff_reference and the JAX kernels): LN statistics in
// f32 with var = E[x^2] - mu^2 clamped at 0, eps 1e-5; exact-erf GELU in f32,
// CUDA's erff standing in for XLA's rational erf (a few f32 ulps apart).
//
// The partials layout, one definition for every kernel that writes them and
// for chanff_bwd.cu's column sums: row tiles of a fixed number of rows (128
// in chanff_bwd.cu, kBwdRows in chanff_chunk.cu; the column sums are told the
// tile count and its rows), tile b at part_d + b * 3 * kD holding the column
// sums over its rows of [0] dxa * xn (LN scale), [1] dxa (LN bias) and [2] dy
// (b2), and at part_f + b * F those of da1 (b1).

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int kD = 512;        // channel width the kernels are built for
constexpr float kEps = 1e-5f;  // LayerNorm epsilon
constexpr int kBwdRows = 16;   // rows per block of chanff_chunk.cu's backward, its partials' tiles

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float gelu_cdf(float a) { return 0.5f * (1.0f + erff(a * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu_pdf(float a) { return expf(-0.5f * a * a) * 0.39894228040143268f; }
__device__ __forceinline__ float gelu(float a) { return a * gelu_cdf(a); }

// LayerNorm of rows [row0, row0 + kRows) of x (R, kD) into xa (shared, row
// stride ld) in T, one warp per row; rows past R are zero. With mu_s, the
// statistics are kept (zero past R); with xa_out, the rounded rows are stored
// there too; with dy, its rows go to dys (row stride ld, zero past R).
template <int kRows, typename T>
__device__ void ln_rows(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, T* xa, int ld, int row0, int R,
                        float* mu_s = nullptr, float* rsig_s = nullptr,
                        T* __restrict__ xa_out = nullptr, const T* __restrict__ dy = nullptr,
                        T* dys = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int r = warp; r < kRows; r += warps) {
    const int row = row0 + r;
    if (row >= R) {
      for (int c = lane; c < kD; c += 32) {
        xa[r * ld + c] = from_f32<T>(0.0f);
        if (dys) dys[r * ld + c] = from_f32<T>(0.0f);
      }
      if (mu_s && lane == 0) { mu_s[r] = 0.0f; rsig_s[r] = 0.0f; }
      continue;
    }
    const T* src = x + (size_t)row * kD;
    float v[kD / 32];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      v[i] = to_f32(src[lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = s / kD;
    const float rsig = rsqrtf(fmaxf(s2 / kD - mu * mu, 0.0f) + kEps);
    if (mu_s && lane == 0) { mu_s[r] = mu; rsig_s[r] = rsig; }
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int c = lane + 32 * i;
      const T a = from_f32<T>((v[i] - mu) * rsig * scale[c] + bias[c]);
      xa[r * ld + c] = a;
      if (xa_out) xa_out[(size_t)row * kD + c] = a;
      if (dys) dys[r * ld + c] = dy[(size_t)row * kD + c];
    }
  }
}

// The end of chanff_chunk.cu's backward, after a barrier that follows the store of
// dxa: the LN backward of the block's kBwdRows rows into dx, one warp per row
// (dxn = dxa * scale; dx = dy + rsig * (dxn - mean(dxn) - xn * mean(dxn * xn))),
// then the block's part_d partials. dxa (f32, row stride ldc), dys (row
// stride ld), mu_s and rsig_s are in shared memory, as ln_rows left them.
template <typename T>
__device__ void ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
                            const float* dxa_s, int ldc, const T* dys, int ld,
                            const float* mu_s, const float* rsig_s, T* __restrict__ dx,
                            float* __restrict__ part_d, int row0, int R) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int r = warp; r < kBwdRows; r += warps) {
    const int row = row0 + r;
    if (row >= R) continue;
    const float mu = mu_s[r], rsig = rsig_s[r];
    float xn[kD / 32], dxn[kD / 32];
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int c = lane + 32 * i;
      xn[i] = (to_f32(x[(size_t)row * kD + c]) - mu) * rsig;
      dxn[i] = dxa_s[r * ldc + c] * scale[c];
      m1 += dxn[i];
      m2 += dxn[i] * xn[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= kD;
    m2 /= kD;
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int c = lane + 32 * i;
      dx[(size_t)row * kD + c] =
          from_f32<T>(to_f32(dys[r * ld + c]) + rsig * (dxn[i] - m1 - xn[i] * m2));
    }
  }

  float* p = part_d + (size_t)blockIdx.x * 3 * kD;
  for (int c = threadIdx.x; c < kD; c += blockDim.x) {
    float sg = 0.0f, sb = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int row = row0 + r;
      if (row >= R) break;
      const float xn = (to_f32(x[(size_t)row * kD + c]) - mu_s[r]) * rsig_s[r];
      const float d = dxa_s[r * ldc + c];
      sg += d * xn;
      sb += d;
      s2 += to_f32(dys[r * ld + c]);
    }
    p[c] = sg;
    p[kD + c] = sb;
    p[2 * kD + c] = s2;
  }
}

}  // namespace
