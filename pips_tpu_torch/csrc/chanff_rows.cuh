// Row-wise device code shared by the channel-block kernels (chanff_fwd.cu,
// chanff_bwd.cu, chanff_chunk.cu) and the token block (token_ff.cu): the
// compute dtype T's conversions (float or bf16), a warp's LN statistics of a
// row, GELU and its derivative. The channel width is each source's own:
// chanff_fwd.cu and chanff_bwd.cu take D (256 or 512) as a template
// parameter, chanff_chunk.cu is built for 512.
//
// Numerics (those of chan_ff_reference and the JAX kernels): LN statistics in
// f32 with var = E[x^2] - mu^2 clamped at 0, eps 1e-5; exact-erf GELU in f32,
// CUDA's erff standing in for XLA's rational erf (a few f32 ulps apart).
//
// The partials layout, one definition for every kernel that writes them and
// for chanff_bwd.cu's column sums: row tiles of a fixed number of rows (128
// in chanff_bwd.cu, 64 in chanff_chunk.cu; the column sums are told the tile
// count and its rows), tile b at part_d + b * 3 * D holding the column sums
// over its rows of [0] dxa * xn (LN scale), [1] dxa (LN bias) and [2] dy
// (b2), and at part_f + b * F those of da1 (b1).

#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float kEps = 1e-5f;  // LayerNorm epsilon

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A row's LN statistics, a warp a row, from each lane's sums of x and x^2
// over its columns: every lane gets mu and rsig = rsqrt(max(E[x^2] - mu^2, 0)
// + eps), E[x^2] - mu^2 as two roundings (PyTorch's and XLA's), not one FMA.
template <int D>
__device__ __forceinline__ void warp_ln_stats(float s, float s2, float& mu, float& rsig) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  mu = s / D;
  rsig = rsqrtf(fmaxf(__fsub_rn(s2 / D, __fmul_rn(mu, mu)), 0.0f) + kEps);
}

__device__ __forceinline__ float gelu_cdf(float a) { return 0.5f * (1.0f + erff(a * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu_pdf(float a) { return expf(-0.5f * a * a) * 0.39894228040143268f; }
__device__ __forceinline__ float gelu(float a) { return a * gelu_cdf(a); }

}  // namespace
