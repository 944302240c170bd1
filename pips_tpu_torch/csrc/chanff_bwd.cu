// Fused MLP-Mixer channel block, backward:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the TPU kernel pips_tpu/kernels/mixer_pallas.py:_chanff_bwd
// (pallas_call of _chanff_bwd_kernel). Given x and dy (R, D) in the compute
// dtype, it recomputes the forward from x and returns dx in x's dtype and f32
// grads of the LN scale and bias, w1, b1, w2 and b2. Training runs it 12 times
// per refinement iteration at D=512, F=2048.
//
// What bounds it on an H100: five products of 2*R*D*F operations each (a1
// recomputed, dg1, dxa, dw1, dw2), 10*R*D*F in all, against x, dy and dx once,
// both bf16 weights once and the f32 weight grads once. At R=1024 that is
// 10.7 GFLOP (10.9 us at 989 TFLOP/s bf16) against ~15 MB (4.5 us at
// 3.35 TB/s), so it is bound by the tensor cores from a few hundred rows up.
//
// Design. The TPU kernel keeps w1 and w2 resident in VMEM and sums dW into one
// output block that every row tile revisits in order. Hopper blocks run in no
// order, cannot hold the 2 MB weights, nor 4 MB of f32 dW each. So:
//   phase A (chanff_bwd_rows), one block per 16 rows, walking F in chunks of
//     64 as the forward does: LN in f32; per chunk, stage the w1 and w2 chunks
//     in shared memory, recompute a1 = xa_c @ w1 + b1 and g1 = gelu(a1), form
//     dg1 = dy_c @ w2^T and da1 = dg1 * gelu'(a1), and add da1_c @ w1^T into a
//     (16, D) f32 dxa held in WMMA registers. xa_c, g1_c and da1_c go to
//     scratch in the compute dtype for phase B; per-block column sums of da1,
//     dy, dxa and dxa*xn go to partials. Then the LN backward gives dx.
//   phase B (chanff_bwd_wgrad): dw1 = xa_c^T @ da1_c and dw2 = g1_c^T @ dy_c
//     as one tiled WMMA GEMM launch over R, f32 accumulation, 64x64 tiles.
//   phase C (chanff_bwd_colsum): the partials summed over blocks in block
//     order, so every grad is deterministic (no atomics).
// 16-row blocks give R/16 blocks in phase A (64 at R=1024) on 132 SMs.
// Rows past R are zero in shared memory, never stored and never read by
// phase B, so they add nothing. bf16 only; an f32 x is refused by the wrapper.
// wgmma/TMA pipelining and a split of F for small R are later work.
//
// Numerics follow chan_ff_bwd_reference (the JAX kernel's math): LN in f32
// with var = E[x^2] - mu^2 clamped at 0, eps 1e-5; the five products take the
// compute dtype and accumulate in f32; db1, db2 and the LN grads are summed in
// f32 from unrounded values; gelu'(a) = Phi(a) + a*phi(a) with CUDA's erff for
// XLA's rational erf (a few f32 ulps apart).
//
// Plain C ABI (loaded with ctypes): pips_chanff_bwd returns cudaGetLastError()
// after the last launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kD = 512;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float gelu_cdf(float a) { return 0.5f * (1.0f + erff(a * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu_pdf(float a) { return expf(-0.5f * a * a) * 0.39894228040143268f; }

// ------------------------------------------------------------------ phase A
namespace rows {
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int TR = 16;                  // rows per block
constexpr int FC = 64;                  // F chunk
constexpr int LDA = kD + 8;             // bf16 row stride of xa, dy and the w2 chunk
constexpr int LDW1 = FC + 8;            // bf16 row stride of the w1 chunk and da1
constexpr int LDH = FC + 4;             // f32 row stride of the a1 / dg1 tiles
constexpr int LDC = kD + 4;             // f32 row stride of dxa (epilogue)
constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t kXa = align128((size_t)TR * LDA * 2);
constexpr size_t kDy = kXa;
constexpr size_t kW1 = align128((size_t)kD * LDW1 * 2);
constexpr size_t kW2 = align128((size_t)FC * LDA * 2);
constexpr size_t kH = align128((size_t)TR * LDH * 4);
constexpr size_t kDa = align128((size_t)TR * LDW1 * 2);
constexpr size_t kStats = align128(2 * TR * 4);
constexpr size_t kSmem = kXa + kDy + kW1 + kW2 + 2 * kH + kDa + kStats;
static_assert((size_t)TR * LDC * 4 <= kW1 + kW2, "dxa tile must fit the weight buffers");
static_assert(2 * (FC / 16) == kWarps, "one a1 or dg1 tile per warp");
constexpr int kAccCols = kD / (16 * kWarps);  // dxa 16x16 tiles per warp

__global__ void __launch_bounds__(kThreads)
chanff_bwd_rows(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                const bf16* __restrict__ w1, const float* __restrict__ b1,
                const bf16* __restrict__ w2, bf16* __restrict__ dx,
                bf16* __restrict__ xa_out, bf16* __restrict__ g1_out, bf16* __restrict__ da1_out,
                float* __restrict__ part_d, float* __restrict__ part_f, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* dys = reinterpret_cast<bf16*>(smem + kXa);
  bf16* w1c = reinterpret_cast<bf16*>(smem + kXa + kDy);
  bf16* w2c = reinterpret_cast<bf16*>(smem + kXa + kDy + kW1);
  float* a1s = reinterpret_cast<float*>(smem + kXa + kDy + kW1 + kW2);
  float* dg1s = reinterpret_cast<float*>(smem + kXa + kDy + kW1 + kW2 + kH);
  bf16* da1s = reinterpret_cast<bf16*>(smem + kXa + kDy + kW1 + kW2 + 2 * kH);
  float* mu_s = reinterpret_cast<float*>(smem + kXa + kDy + kW1 + kW2 + 2 * kH + kDa);
  float* rsig_s = mu_s + TR;
  float* dxa_s = reinterpret_cast<float*>(smem + kXa + kDy);  // reuses w1c/w2c after the loop

  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LN of the block's rows (f32 statistics), xa and dy into shared memory in bf16
  for (int r = warp; r < TR; r += kWarps) {
    const int row = row0 + r;
    bf16* xdst = xa + r * LDA;
    bf16* ddst = dys + r * LDA;
    if (row >= R) {
      for (int c = lane; c < kD; c += 32) {
        xdst[c] = __float2bfloat16(0.0f);
        ddst[c] = __float2bfloat16(0.0f);
      }
      if (lane == 0) { mu_s[r] = 0.0f; rsig_s[r] = 0.0f; }
      continue;
    }
    const bf16* src = x + (size_t)row * kD;
    float v[kD / 32];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      v[i] = __bfloat162float(src[lane + 32 * i]);
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
    if (lane == 0) { mu_s[r] = mu; rsig_s[r] = rsig; }
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int c = lane + 32 * i;
      const bf16 xa_c = __float2bfloat16((v[i] - mu) * rsig * ln_scale[c] + ln_bias[c]);
      xdst[c] = xa_c;
      xa_out[(size_t)row * kD + c] = xa_c;
      ddst[c] = dy[(size_t)row * kD + c];
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kAccCols];
#pragma unroll
  for (int j = 0; j < kAccCols; ++j) wmma::fill_fragment(acc[j], 0.0f);
  const int col0 = warp * kAccCols * 16;  // this warp's dxa columns

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

    {  // warps 0-3: a1 = xa @ w1 chunk; warps 4-7: dg1 = dy @ w2 chunk^T. One 16x16 tile each.
      const bool is_a1 = warp < FC / 16;
      const int c = (warp % (FC / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
      wmma::fill_fragment(h, 0.0f);
      if (is_a1) {
#pragma unroll 4
        for (int k = 0; k < kD; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, xa + k, LDA);
          wmma::load_matrix_sync(b, w1c + k * LDW1 + c, LDW1);
          wmma::mma_sync(h, a, b, h);
        }
        wmma::store_matrix_sync(a1s + c, h, LDH, wmma::mem_row_major);
      } else {
#pragma unroll 4
        for (int k = 0; k < kD; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;  // w2c^T
          wmma::load_matrix_sync(a, dys + k, LDA);
          wmma::load_matrix_sync(b, w2c + c * LDA + k, LDA);
          wmma::mma_sync(h, a, b, h);
        }
        wmma::store_matrix_sync(dg1s + c, h, LDH, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // elementwise: g1, da1 = dg1 * gelu'(a1); scratch out in bf16; da1 (f32) kept in dg1s
    for (int i = threadIdx.x; i < TR * FC; i += kThreads) {
      const int r = i / FC, c = i % FC;
      const int row = row0 + r;
      const float a = a1s[r * LDH + c] + b1[f0 + c];
      const float cdf = gelu_cdf(a);
      const float da = dg1s[r * LDH + c] * (cdf + a * gelu_pdf(a));
      const bf16 da_c = __float2bfloat16(da);
      dg1s[r * LDH + c] = da;
      da1s[r * LDW1 + c] = da_c;
      if (row < R) {
        const size_t o = (size_t)row * F + f0 + c;
        g1_out[o] = __float2bfloat16(a * cdf);
        da1_out[o] = da_c;
      }
    }
    __syncthreads();
    if (threadIdx.x < FC) {  // db1 partial: column sums of da1 over the block's rows
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TR; ++r) s += dg1s[r * LDH + threadIdx.x];
      part_f[(size_t)blockIdx.x * F + f0 + threadIdx.x] = s;
    }
    // dxa += da1_c (TR, FC) @ w1 chunk^T (FC, kD)
#pragma unroll
    for (int k = 0; k < FC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, da1s + k, LDW1);
#pragma unroll
      for (int j = 0; j < kAccCols; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;  // w1c^T
        wmma::load_matrix_sync(b, w1c + (col0 + j * 16) * LDW1 + k, LDW1);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __syncthreads();  // every warp is done with w1c/w2c before dxa_s overwrites them
#pragma unroll
  for (int j = 0; j < kAccCols; ++j)
    wmma::store_matrix_sync(dxa_s + col0 + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();

  // LN backward per row: dxn = dxa * scale; dx = dy + rsig * (dxn - mean(dxn) - xn * mean(dxn * xn))
  for (int r = warp; r < TR; r += kWarps) {
    const int row = row0 + r;
    if (row >= R) continue;
    const float mu = mu_s[r], rsig = rsig_s[r];
    float xn[kD / 32], dxn[kD / 32];
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int c = lane + 32 * i;
      xn[i] = (__bfloat162float(x[(size_t)row * kD + c]) - mu) * rsig;
      dxn[i] = dxa_s[r * LDC + c] * ln_scale[c];
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
      const float d = __bfloat162float(dys[r * LDA + c]);
      dx[(size_t)row * kD + c] = __float2bfloat16(d + rsig * (dxn[i] - m1 - xn[i] * m2));
    }
  }

  // per-block column partials over D: [0] LN scale (dxa * xn), [1] LN bias (dxa), [2] b2 (dy)
  for (int c = threadIdx.x; c < kD; c += kThreads) {
    float sg = 0.0f, sb = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + r;
      if (row >= R) break;
      const float xn = (__bfloat162float(x[(size_t)row * kD + c]) - mu_s[r]) * rsig_s[r];
      const float d = dxa_s[r * LDC + c];
      sg += d * xn;
      sb += d;
      s2 += __bfloat162float(dys[r * LDA + c]);
    }
    float* p = part_d + (size_t)blockIdx.x * 3 * kD;
    p[c] = sg;
    p[kD + c] = sb;
    p[2 * kD + c] = s2;
  }
}
}  // namespace rows

// ------------------------------------------------------------------ phase B
namespace wgrad {
constexpr int kThreads = 128;  // 4 warps, 2x2 over the tile
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = 64 + 8;    // bf16 row stride of the staged A and B tiles
constexpr int WM = BM / 2, WN = BN / 2;

// C (M, N) f32 = A^T B, A (K, M) and B (K, N) row-major bf16; M, N multiples of 64.
// Blocks [0, tiles0) compute the first product, the rest the second.
struct Gemm {
  const bf16* A;
  const bf16* B;
  float* C;
  int M, N;
};

__global__ void __launch_bounds__(kThreads)
chanff_bwd_wgrad(Gemm g0, Gemm g1, int tiles0, int K) {
  __shared__ __align__(128) bf16 As[BK * LDS];
  __shared__ __align__(128) bf16 Bs[BK * LDS];
  const bool first = (int)blockIdx.x < tiles0;
  const Gemm g = first ? g0 : g1;
  const int t = first ? blockIdx.x : blockIdx.x - tiles0;
  const int tiles_n = g.N / BN;
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * WM, wn = (warp % 2) * WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage A[k0:k0+BK, m0:m0+BM] and B[k0:k0+BK, n0:n0+BN]; rows past K are zero
    for (int i = threadIdx.x; i < BK * (BM / 8); i += kThreads) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const int k = k0 + r;
      *reinterpret_cast<uint4*>(As + r * LDS + c) =
          k < K ? *reinterpret_cast<const uint4*>(g.A + (size_t)k * g.M + m0 + c) : zero;
      *reinterpret_cast<uint4*>(Bs + r * LDS + c) =
          k < K ? *reinterpret_cast<const uint4*>(g.B + (size_t)k * g.N + n0 + c) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[WM / 16];  // A^T
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], As + k * LDS + wm + i * 16, LDS);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + k * LDS + wn + j * 16, LDS);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j)
      wmma::store_matrix_sync(g.C + (size_t)(m0 + wm + i * 16) * g.N + n0 + wn + j * 16,
                              acc[i][j], g.N, wmma::mem_row_major);
}
}  // namespace wgrad

// ------------------------------------------------------------------ phase C
// out[c] = sum over blocks b (in order) of part[b * stride + c], c < n.
__global__ void chanff_bwd_colsum(const float* __restrict__ part_d,
                                  const float* __restrict__ part_f, float* __restrict__ dg,
                                  float* __restrict__ db, float* __restrict__ db2,
                                  float* __restrict__ db1, int nblk, int F) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < 3 * kD) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_d[(size_t)b * 3 * kD + c];
    float* out = c < kD ? dg : (c < 2 * kD ? db : db2);
    out[c % kD] = s;
  } else if (c < 3 * kD + F) {
    const int f = c - 3 * kD;
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_f[(size_t)b * F + f];
    db1[f] = s;
  }
}

}  // namespace

extern "C" {

// Scratch the caller allocates (bytes): xa (R*D bf16), g1 and da1 (R*F bf16
// each), part_d (ceil(R/16)*3*D f32), part_f (ceil(R/16)*F f32); see
// pips_chanff_bwd_scratch. Shapes the kernel takes: D == 512, F a multiple of
// 64, R >= 1, bf16 x/dy/w1/w2/dx; all pointers 16-byte aligned and contiguous.
int pips_chanff_bwd_blocks(int R) { return (R + rows::TR - 1) / rows::TR; }

int pips_chanff_bwd(const void* x, const void* dy, const void* ln_scale, const void* ln_bias,
                    const void* w1, const void* b1, const void* w2, void* dx, void* dg,
                    void* db, void* dw1, void* db1, void* dw2, void* db2, void* xa_scratch,
                    void* g1_scratch, void* da1_scratch, void* part_d, void* part_f, int R,
                    int D, int F, int device, void* stream) {
  if (D != kD || F <= 0 || F % rows::FC != 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(rows::chanff_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = pips_chanff_bwd_blocks(R);
  bf16* xa = static_cast<bf16*>(xa_scratch);
  bf16* g1 = static_cast<bf16*>(g1_scratch);
  bf16* da1 = static_cast<bf16*>(da1_scratch);
  rows::chanff_bwd_rows<<<nblk, rows::kThreads, rows::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(dx), xa, g1, da1,
      static_cast<float*>(part_d), static_cast<float*>(part_f), R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dw1 (D, F) = xa^T da1; dw2 (F, D) = g1^T dy
  const wgrad::Gemm g0{xa, da1, static_cast<float*>(dw1), kD, F};
  const wgrad::Gemm gb{g1, static_cast<const bf16*>(dy), static_cast<float*>(dw2), F, kD};
  const int tiles = (kD / wgrad::BM) * (F / wgrad::BN);
  wgrad::chanff_bwd_wgrad<<<2 * tiles, wgrad::kThreads, 0, s>>>(g0, gb, tiles, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ncol = 3 * kD + F;
  chanff_bwd_colsum<<<(ncol + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const float*>(part_f),
      static_cast<float*>(dg), static_cast<float*>(db), static_cast<float*>(db2),
      static_cast<float*>(db1), nblk, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
