// Fused MLP-Mixer channel block, backward:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the TPU kernel pips_tpu/kernels/mixer_pallas.py:_chanff_bwd
// (pallas_call of _chanff_bwd_kernel). Given x and dy (R, D) in the compute
// dtype, it recomputes the forward from x and returns dx in x's dtype and f32
// grads of the LN scale and bias, w1, b1, w2 and b2. Training runs it 12 times
// per refinement iteration at D=512, F=2048, in bf16 or (with --dtype float32)
// in f32.
//
// What bounds it on an H100: five products of 2*R*D*F operations each (a1
// recomputed, dg1, dxa, dw1, dw2), 10*R*D*F in all, against x, dy and dx once,
// both weights once and the f32 weight grads once. In bf16 at R=1024 that is
// 10.7 GFLOP (10.9 us at 989 TFLOP/s) against ~15 MB (4.5 us at 3.35 TB/s), so
// it is bound by the tensor cores from a few hundred rows up; in f32 the same
// work takes 160 us at the 67 TFLOP/s of the FMA units.
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
// phase B, so they add nothing. wgmma/TMA pipelining and a split of F for
// small R are later work.
//
// f32 (namespaces rows32, wgrad32) keeps the three phases on SIMT FMAs:
// mma.sync with f32 operands is TF32, which would drop the f32 products the
// reference keeps (chanff_fwd.cu makes the same choice). Phase A holds 16 rows
// of xa and dy in f32 (64 KB) and takes F in chunks of 32 so that the f32 w1
// and w2 chunks (136 KB) fit beside them; each thread keeps 16 rows x 2
// columns of dxa in registers. Phase B is a 64x64-tile SGEMM over R, 4x4
// outputs a thread. Scratch (xa, g1, da1) is f32: ~450 MB at R=24,576.
//
// Numerics follow chan_ff_bwd_reference (the JAX kernel's math): LN in f32
// with var = E[x^2] - mu^2 clamped at 0, eps 1e-5; the five products take the
// compute dtype and accumulate in f32; db1, db2 and the LN grads are summed in
// f32 from unrounded values; gelu'(a) = Phi(a) + a*phi(a) with CUDA's erff for
// XLA's rational erf (a few f32 ulps apart).
//
// Plain C ABI (loaded with ctypes): pips_chanff_bwd returns cudaGetLastError()
// after the last launch; 0 means launched. pips_chanff_bwd_finish runs phases
// B and C alone on bf16 scratch that another phase A wrote (the F-chunked
// kernel of chanff_chunk.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "chanff_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ------------------------------------------------------------------ phase A
namespace rows {
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int TR = kBwdRows;            // rows per block
constexpr int FC = 64;                  // F chunk
constexpr int LDA = kD + 8;             // bf16 row stride of xa, dy and the w2 chunk
constexpr int LDW1 = FC + 8;            // bf16 row stride of the w1 chunk and da1
constexpr int LDH = FC + 4;             // f32 row stride of the a1 / dg1 tiles
constexpr int LDC = kD + 4;             // f32 row stride of dxa (epilogue)
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
  const int warp = threadIdx.x / 32;

  // LN of the block's rows (f32 statistics), xa and dy into shared memory in bf16
  ln_rows<TR>(x, ln_scale, ln_bias, xa, LDA, row0, R, mu_s, rsig_s, xa_out, dy, dys);

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

  ln_bwd_rows(x, ln_scale, dxa_s, LDC, dys, LDA, mu_s, rsig_s, dx, part_d, row0, R);
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

// ------------------------------------------------------------ phase A, f32
namespace rows32 {
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int TR = kBwdRows;            // rows per block
constexpr int FC = 32;                  // F chunk
constexpr int LDX = kD + 4;             // f32 row stride of xa, dy, the w2 chunk and dxa
constexpr int LDW1 = FC + 4;            // f32 row stride of the w1 chunk and the a1 / da1 tiles
constexpr size_t kXa = align128((size_t)TR * LDX * 4);
constexpr size_t kW1 = align128((size_t)kD * LDW1 * 4);
constexpr size_t kW2 = align128((size_t)FC * LDX * 4);
constexpr size_t kH = align128((size_t)TR * LDW1 * 4);
constexpr size_t kStats = align128(2 * TR * 4);
constexpr size_t kSmem = 2 * kXa + kW1 + kW2 + 2 * kH + kStats;
static_assert(kSmem <= 232448, "phase A must fit a block's shared memory");
static_assert(kXa <= kW1, "dxa must fit the w1 chunk's buffer");
// a1 and dg1: warps 0-3 and 4-7, four rows each, one chunk column per lane
static_assert(FC == 32 && 4 * (kWarps / 2) == TR, "a1/dg1 thread map");
// dxa: thread t owns all TR rows of columns t and t + kThreads
static_assert(2 * kThreads == kD, "dxa thread map");

__global__ void __launch_bounds__(kThreads)
chanff_bwd_rows_f32(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, float* __restrict__ dx,
                    float* __restrict__ xa_out, float* __restrict__ g1_out,
                    float* __restrict__ da1_out, float* __restrict__ part_d,
                    float* __restrict__ part_f, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xa = reinterpret_cast<float*>(smem);
  float* dys = reinterpret_cast<float*>(smem + kXa);
  float* w1c = reinterpret_cast<float*>(smem + 2 * kXa);
  float* w2c = reinterpret_cast<float*>(smem + 2 * kXa + kW1);
  float* a1s = reinterpret_cast<float*>(smem + 2 * kXa + kW1 + kW2);
  float* da1s = reinterpret_cast<float*>(smem + 2 * kXa + kW1 + kW2 + kH);
  float* mu_s = reinterpret_cast<float*>(smem + 2 * kXa + kW1 + kW2 + 2 * kH);
  float* rsig_s = mu_s + TR;
  float* dxa_s = w1c;  // reuses the w1 chunk after the loop

  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LN of the block's rows (f32 statistics), xa and dy into shared memory
  ln_rows<TR>(x, ln_scale, ln_bias, xa, LDX, row0, R, mu_s, rsig_s, xa_out, dy, dys);

  float acc[TR][2];  // dxa, rows 0..TR-1 of columns threadIdx.x and threadIdx.x + kThreads
#pragma unroll
  for (int r = 0; r < TR; ++r) acc[r][0] = acc[r][1] = 0.0f;
  const bool is_a1 = warp < kWarps / 2;
  const int hr = (warp % (kWarps / 2)) * 4;  // this warp's a1 or dg1 rows

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // LN rows written / previous chunk fully consumed
    for (int i = threadIdx.x; i < kD * FC / 4; i += kThreads) {
      const int r = i / (FC / 4), c = (i % (FC / 4)) * 4;
      *reinterpret_cast<float4*>(w1c + r * LDW1 + c) =
          *reinterpret_cast<const float4*>(w1 + (size_t)r * F + f0 + c);
    }
    for (int i = threadIdx.x; i < FC * kD / 4; i += kThreads) {
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      *reinterpret_cast<float4*>(w2c + r * LDX + c) =
          *reinterpret_cast<const float4*>(w2 + (size_t)(f0 + r) * kD + c);
    }
    __syncthreads();

    {  // warps 0-3: a1 = xa @ w1 chunk + b1; warps 4-7: dg1 = dy @ w2 chunk^T
      float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* arow = (is_a1 ? xa : dys) + hr * LDX;
      if (is_a1) {
#pragma unroll 2
        for (int k = 0; k < kD; k += 4) {
          const float w[4] = {w1c[k * LDW1 + lane], w1c[(k + 1) * LDW1 + lane],
                              w1c[(k + 2) * LDW1 + lane], w1c[(k + 3) * LDW1 + lane]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(arow + i * LDX + k);
            h[i] = fmaf(a.x, w[0], h[i]);
            h[i] = fmaf(a.y, w[1], h[i]);
            h[i] = fmaf(a.z, w[2], h[i]);
            h[i] = fmaf(a.w, w[3], h[i]);
          }
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < kD; k += 4) {
          const float4 w = *reinterpret_cast<const float4*>(w2c + lane * LDX + k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(arow + i * LDX + k);
            h[i] = fmaf(a.x, w.x, h[i]);
            h[i] = fmaf(a.y, w.y, h[i]);
            h[i] = fmaf(a.z, w.z, h[i]);
            h[i] = fmaf(a.w, w.w, h[i]);
          }
        }
      }
      const float bias = is_a1 ? b1[f0 + lane] : 0.0f;
      float* dst = is_a1 ? a1s : da1s;
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(hr + i) * LDW1 + lane] = h[i] + bias;
    }
    __syncthreads();
    // elementwise: g1 = gelu(a1), da1 = dg1 * gelu'(a1) (kept in da1s); scratch out
    for (int i = threadIdx.x; i < TR * FC; i += kThreads) {
      const int r = i / FC, c = i % FC;
      const int row = row0 + r;
      const float a = a1s[r * LDW1 + c];
      const float cdf = gelu_cdf(a);
      const float da = da1s[r * LDW1 + c] * (cdf + a * gelu_pdf(a));
      da1s[r * LDW1 + c] = da;
      if (row < R) {
        const size_t o = (size_t)row * F + f0 + c;
        g1_out[o] = a * cdf;
        da1_out[o] = da;
      }
    }
    __syncthreads();
    if (threadIdx.x < FC) {  // db1 partial: column sums of da1 over the block's rows
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TR; ++r) s += da1s[r * LDW1 + threadIdx.x];
      part_f[(size_t)blockIdx.x * F + f0 + threadIdx.x] = s;
    }
    // dxa += da1 (TR, FC) @ w1 chunk^T (FC, kD)
#pragma unroll 2
    for (int f = 0; f < FC; f += 4) {
      const float4 wa = *reinterpret_cast<const float4*>(w1c + threadIdx.x * LDW1 + f);
      const float4 wb = *reinterpret_cast<const float4*>(w1c + (threadIdx.x + kThreads) * LDW1 + f);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(da1s + r * LDW1 + f);
        acc[r][0] = fmaf(d.x, wa.x, acc[r][0]);
        acc[r][0] = fmaf(d.y, wa.y, acc[r][0]);
        acc[r][0] = fmaf(d.z, wa.z, acc[r][0]);
        acc[r][0] = fmaf(d.w, wa.w, acc[r][0]);
        acc[r][1] = fmaf(d.x, wb.x, acc[r][1]);
        acc[r][1] = fmaf(d.y, wb.y, acc[r][1]);
        acc[r][1] = fmaf(d.z, wb.z, acc[r][1]);
        acc[r][1] = fmaf(d.w, wb.w, acc[r][1]);
      }
    }
  }

  __syncthreads();  // every thread is done with w1c before dxa_s overwrites it
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    dxa_s[r * LDX + threadIdx.x] = acc[r][0];
    dxa_s[r * LDX + threadIdx.x + kThreads] = acc[r][1];
  }
  __syncthreads();

  ln_bwd_rows(x, ln_scale, dxa_s, LDX, dys, LDX, mu_s, rsig_s, dx, part_d, row0, R);
}
}  // namespace rows32

// ------------------------------------------------------------ phase B, f32
namespace wgrad32 {
constexpr int kThreads = 256;  // 16x16 threads, 4x4 outputs each
constexpr int BM = 64, BN = 64, BK = 16;
static_assert(BK * BM == 4 * kThreads && BK * BN == 4 * kThreads, "one float4 per thread per tile");

// C (M, N) f32 = A^T B, A (K, M) and B (K, N) row-major f32; M, N multiples of 64.
// Blocks [0, tiles0) compute the first product, the rest the second.
struct Gemm {
  const float* A;
  const float* B;
  float* C;
  int M, N;
};

__global__ void __launch_bounds__(kThreads)
chanff_bwd_wgrad_f32(Gemm g0, Gemm g1, int tiles0, int K) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const bool first = (int)blockIdx.x < tiles0;
  const Gemm g = first ? g0 : g1;
  const int t = first ? blockIdx.x : blockIdx.x - tiles0;
  const int tiles_n = g.N / BN;
  const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
  const int tm = (threadIdx.x / 16) * 4, tn = (threadIdx.x % 16) * 4;  // this thread's outputs
  const int lr = threadIdx.x / 16, lc = (threadIdx.x % 16) * 4;        // its staged float4

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + lr;  // rows past K are zero
    *reinterpret_cast<float4*>(&As[lr][lc]) =
        k < K ? *reinterpret_cast<const float4*>(g.A + (size_t)k * g.M + m0 + lc) : zero;
    *reinterpret_cast<float4*>(&Bs[lr][lc]) =
        k < K ? *reinterpret_cast<const float4*>(g.B + (size_t)k * g.N + n0 + lc) : zero;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][tm]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tn]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(g.C + (size_t)(m0 + tm + i) * g.N + n0 + tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}
}  // namespace wgrad32

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

// Phases B and C on bf16 scratch: dw1 (D, F) = xa^T da1, dw2 (F, D) = g1^T dy,
// then the partials' ordered column sums.
cudaError_t finish_bf16(const bf16* xa, const bf16* g1, const bf16* da1, const bf16* dy,
                        float* dg, float* db, float* dw1, float* db1, float* dw2, float* db2,
                        const float* part_d, const float* part_f, int R, int F, int nblk,
                        cudaStream_t s) {
  const wgrad::Gemm g0{xa, da1, dw1, kD, F};
  const wgrad::Gemm gb{g1, dy, dw2, F, kD};
  const int tiles = (kD / wgrad::BM) * (F / wgrad::BN);
  wgrad::chanff_bwd_wgrad<<<2 * tiles, wgrad::kThreads, 0, s>>>(g0, gb, tiles, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncol = 3 * kD + F;
  chanff_bwd_colsum<<<(ncol + 255) / 256, 256, 0, s>>>(part_d, part_f, dg, db, db2, db1, nblk, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the caller allocates, in the compute dtype: xa (R*D), g1 and da1
// (R*F each); and f32 part_d (ceil(R/16)*3*D), part_f (ceil(R/16)*F), see
// pips_chanff_bwd_blocks. Shapes the kernel takes: D == 512, F a multiple of
// 64, R >= 1. dtype_code 0 = float32, 1 = bfloat16 (x, dy, w1, w2, dx and the
// scratch); all pointers 16-byte aligned and contiguous.
int pips_chanff_bwd_blocks(int R) { return (R + kBwdRows - 1) / kBwdRows; }

int pips_chanff_bwd(const void* x, const void* dy, const void* ln_scale, const void* ln_bias,
                    const void* w1, const void* b1, const void* w2, void* dx, void* dg,
                    void* db, void* dw1, void* db1, void* dw2, void* db2, void* xa_scratch,
                    void* g1_scratch, void* da1_scratch, void* part_d, void* part_f, int R,
                    int D, int F, int dtype_code, int device, void* stream) {
  if (D != kD || F <= 0 || F % rows::FC != 0 || R <= 0 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = pips_chanff_bwd_blocks(R);
  const float* g = static_cast<const float*>(ln_scale);
  const float* b = static_cast<const float*>(ln_bias);
  const float* bb1 = static_cast<const float*>(b1);
  float* pd = static_cast<float*>(part_d);
  float* pf = static_cast<float*>(part_f);
  if (dtype_code == 1) {
    err = cudaFuncSetAttribute(rows::chanff_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rows::kSmem);
    if (err != cudaSuccess) return (int)err;
    bf16* xa = static_cast<bf16*>(xa_scratch);
    bf16* g1 = static_cast<bf16*>(g1_scratch);
    bf16* da1 = static_cast<bf16*>(da1_scratch);
    rows::chanff_bwd_rows<<<nblk, rows::kThreads, rows::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), g, b,
        static_cast<const bf16*>(w1), bb1, static_cast<const bf16*>(w2), static_cast<bf16*>(dx),
        xa, g1, da1, pd, pf, R, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)finish_bf16(xa, g1, da1, static_cast<const bf16*>(dy), static_cast<float*>(dg),
                            static_cast<float*>(db), static_cast<float*>(dw1),
                            static_cast<float*>(db1), static_cast<float*>(dw2),
                            static_cast<float*>(db2), pd, pf, R, F, nblk, s);
  }
  err = cudaFuncSetAttribute(rows32::chanff_bwd_rows_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows32::kSmem);
  if (err != cudaSuccess) return (int)err;
  float* xa = static_cast<float*>(xa_scratch);
  float* g1 = static_cast<float*>(g1_scratch);
  float* da1 = static_cast<float*>(da1_scratch);
  rows32::chanff_bwd_rows_f32<<<nblk, rows32::kThreads, rows32::kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), g, b,
      static_cast<const float*>(w1), bb1, static_cast<const float*>(w2), static_cast<float*>(dx),
      xa, g1, da1, pd, pf, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const wgrad32::Gemm g0{xa, da1, static_cast<float*>(dw1), kD, F};
  const wgrad32::Gemm gb{g1, static_cast<const float*>(dy), static_cast<float*>(dw2), F, kD};
  const int tiles = (kD / wgrad32::BM) * (F / wgrad32::BN);
  wgrad32::chanff_bwd_wgrad_f32<<<2 * tiles, wgrad32::kThreads, 0, s>>>(g0, gb, tiles, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ncol = 3 * kD + F;
  chanff_bwd_colsum<<<(ncol + 255) / 256, 256, 0, s>>>(
      pd, pf, static_cast<float*>(dg), static_cast<float*>(db), static_cast<float*>(db2),
      static_cast<float*>(db1), nblk, F);
  return (int)cudaGetLastError();
}

// Phases B and C alone, bf16, on scratch in pips_chanff_bwd's layout that
// another phase A wrote in nblk blocks of 16 rows (chanff_chunk.cu's).
int pips_chanff_bwd_finish(const void* xa, const void* g1, const void* da1, const void* dy,
                           void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2,
                           const void* part_d, const void* part_f, int R, int F, int nblk,
                           int device, void* stream) {
  if (F <= 0 || F % wgrad::BN != 0 || R <= 0 || nblk != pips_chanff_bwd_blocks(R))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)finish_bf16(static_cast<const bf16*>(xa), static_cast<const bf16*>(g1),
                          static_cast<const bf16*>(da1), static_cast<const bf16*>(dy),
                          static_cast<float*>(dg), static_cast<float*>(db),
                          static_cast<float*>(dw1), static_cast<float*>(db1),
                          static_cast<float*>(dw2), static_cast<float*>(db2),
                          static_cast<const float*>(part_d), static_cast<const float*>(part_f),
                          R, F, nblk, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
