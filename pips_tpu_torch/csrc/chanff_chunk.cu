// F-chunked MLP-Mixer channel block, bf16:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the two TPU kernels of tools/profile_chanff_chunk.py's
// make_chunked: its forward (pallas_call at :121 of _fwd_kernel_chunked) and
// its backward (:149, _bwd_kernel_chunked). They compute the channel block of
// chanff_fwd.cu and chanff_bwd.cu with F walked in static chunks of FC
// columns, one (rows, FC) pre-activation tile per chunk: a matmul, GELU over
// the whole tile, a matmul. The tool times a 12-block chain of them at
// R=1024, D=512, F=2048 against the monolithic kernels.
//
// What bounds it on an H100: as for the monolithic kernels, 4*R*D*F
// operations forward and 10*R*D*F backward at the bf16 tensor-core rate (at
// R=1024: 4.3 us and 10.9 us at 989 TFLOP/s), against a few MB of rows and
// weights; so the tensor cores, from a few hundred rows up.
//
// Design. The TPU kernel holds w1 and w2 whole in VMEM and slices them per
// chunk. A Hopper block has 227 KB of shared memory, and a w1 chunk alone is
// 1 MB at FC=1024. So each block owns 16 rows, keeps the chunk's (16, FC)
// tile in shared memory, and streams the weights through one buffer:
//   forward (chanff_chunk_fwd<FC>): a1 = xa @ w1[:, chunk], w1 in slices of
//     32 rows, each warp accumulating its FC/8 columns in WMMA registers;
//     + b1, GELU and one bf16 rounding per element, through a per-warp 16x16
//     f32 staging tile, into the bf16 g1 tile; then o += g1 @ w2[chunk, :],
//     w2 in slices of 64 rows, o (16, 512) f32 in registers across chunks.
//     Epilogue: y = x + o + b2, rounded once.
//   backward phase A (chanff_chunk_bwd_rows<FC>): per chunk, a1 into an f32
//     tile and dg1 = dy @ w2[chunk, :]^T (w2 in slices of 16 or 32 of its 512
//     columns), each warp on its own FC/8 columns of both, so that
//     da1 = dg1 * gelu'(a1) needs no block barrier; g1 and da1 go to scratch,
//     da1 also into a bf16 (16, FC) tile; then dxa += da1 @ w1[:, chunk]^T,
//     w1 streamed again in slices of 32 columns. The LN backward and the
//     per-block partials are chanff_rows.cuh's, and chanff_bwd.cu's phases B and C
//     (pips_chanff_bwd_finish, called by the wrapper) finish the grads.
// FC is a template parameter: 128, 256, 512 or 1024. Each backward chunk reads
// w1 twice, where chanff_bwd.cu's 64-wide chunks hold it for both products.
// Rows past R are zero in shared memory and never stored. wgmma/TMA
// pipelining is later work.
//
// Numerics follow the JAX chunked kernels (chan_ff_chunked_reference and its
// backward): LN in f32 (var = E[x^2] - mu^2 clamped at 0, eps 1e-5); the fc1
// and fc2 products of bf16 operands accumulate in f32 and take the f32 bias
// unrounded; o and dxa accumulate chunk by chunk in f32; y is rounded once.
// CUDA's erff stands in for XLA's rational erf (a few f32 ulps apart).
//
// Plain C ABI (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; 0 means launched.

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
constexpr int TR = kBwdRows;   // rows per block, as the partials layout has them
constexpr int LDA = kD + 8;    // bf16 row stride of xa, dy and a w2 row slice
constexpr int LDS = 16 + 4;    // f32 row stride of a warp's 16x16 staging tile
constexpr int LDC = kD + 4;    // f32 row stride of the (16, D) epilogue tile
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t kXa = align128((size_t)TR * LDA * 2);
constexpr size_t kStage = align128((size_t)kWarps * 16 * LDS * 4);
constexpr size_t kStats = align128(2 * TR * 4);

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

// All threads: copy a (rows, cols) bf16 block, cols a multiple of 8, from src
// (row stride lds) to dst (row stride ldd) in 16-byte pieces.
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* __restrict__ src,
                                      size_t lds, int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// ------------------------------------------------------------------ forward
template <int FC>
struct Fwd {
  static constexpr int NJ = FC / (16 * kWarps);  // a1 16x16 tiles per warp
  static constexpr int KS1 = 32;                 // w1 rows per slice
  static constexpr int KS2 = 64;                 // w2 rows per slice
  static constexpr int LDW = FC + 8;             // bf16 row stride of a w1 slice and the g1 tile
  static constexpr size_t kG = align128((size_t)TR * LDW * 2);
  static constexpr size_t kBuf = align128(cmax(cmax((size_t)KS1 * LDW * 2, (size_t)KS2 * LDA * 2),
                                               (size_t)TR * LDC * 4));
  static constexpr size_t kSmem = kXa + kG + kStage + kBuf;
  static_assert(NJ >= 1 && FC % KS2 == 0 && kD % KS1 == 0, "chunk width");
  static_assert(kSmem <= 232448, "the forward must fit a block's shared memory");
};

template <int FC>
__global__ void __launch_bounds__(kThreads)
chanff_chunk_fwd(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ y, int R, int F) {
  using C = Fwd<FC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* g1 = reinterpret_cast<bf16*>(smem + kXa);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stg = reinterpret_cast<float*>(smem + kXa + C::kG) + warp * 16 * LDS;
  bf16* buf = reinterpret_cast<bf16*>(smem + kXa + C::kG + kStage);
  float* out = reinterpret_cast<float*>(buf);  // the epilogue tile, after the loop

  const int row0 = blockIdx.x * TR;
  ln_rows<TR>(x, ln_scale, ln_bias, xa, LDA, row0, R);

  Acc o[kD / (16 * kWarps)];
#pragma unroll
  for (int j = 0; j < kD / (16 * kWarps); ++j) wmma::fill_fragment(o[j], 0.0f);
  const int fcol = warp * (FC / kWarps);  // this warp's chunk columns
  const int dcol = warp * (kD / kWarps);  // and output columns

  for (int f0 = 0; f0 < F; f0 += FC) {
    Acc h[C::NJ];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) wmma::fill_fragment(h[j], 0.0f);
    for (int k0 = 0; k0 < kD; k0 += C::KS1) {
      __syncthreads();  // LN rows written / the buffer's last slice consumed
      stage(buf, C::LDW, w1 + (size_t)k0 * F + f0, F, C::KS1, FC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < C::KS1; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, xa + k0 + kk, LDA);
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, buf + kk * C::LDW + fcol + 16 * j, C::LDW);
          wmma::mma_sync(h[j], a, b, h[j]);
        }
      }
    }
    // + b1, GELU, one rounding: the warp's tiles through its staging tile into g1
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      wmma::store_matrix_sync(stg, h[j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, col = fcol + 16 * j + e % 16;
        const float a = stg[r * LDS + e % 16] + b1[f0 + col];
        g1[r * C::LDW + col] = __float2bfloat16(gelu(a));
      }
      __syncwarp();
    }
    // o += g1 (TR, FC) @ w2[f0:f0+FC, :]
    for (int s0 = 0; s0 < FC; s0 += C::KS2) {
      __syncthreads();  // g1 complete / the buffer's last slice consumed
      stage(buf, LDA, w2 + (size_t)(f0 + s0) * kD, kD, C::KS2, kD);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < C::KS2; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, g1 + s0 + kk, C::LDW);
#pragma unroll
        for (int j = 0; j < kD / (16 * kWarps); ++j) {
          FragB b;
          wmma::load_matrix_sync(b, buf + kk * LDA + dcol + 16 * j, LDA);
          wmma::mma_sync(o[j], a, b, o[j]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the buffer before the epilogue tile overwrites it
#pragma unroll
  for (int j = 0; j < kD / (16 * kWarps); ++j)
    wmma::store_matrix_sync(out + dcol + 16 * j, o[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TR * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    if (row < R) {
      const size_t idx = (size_t)row * kD + c;
      y[idx] = __float2bfloat16(__bfloat162float(x[idx]) + out[r * LDC + c] + b2[c]);
    }
  }
}

// ------------------------------------------------------- backward, phase A
template <int FC>
struct Bwd {
  static constexpr int NJ = FC / (16 * kWarps);  // a1 / dg1 16x16 tiles per warp
  static constexpr int KS1 = 32;                 // w1 rows per slice (a1)
  static constexpr int KS2 = FC >= 1024 ? 16 : 32;  // w2 columns per slice (dg1)
  static constexpr int KS3 = 32;                 // w1 chunk columns per slice (dxa)
  static constexpr int LDW = FC + 8;             // bf16 row stride of a w1 row slice and the da1 tile
  static constexpr int LDT = FC + 4;             // f32 row stride of the a1 tile
  static constexpr int LDW2 = KS2 + 8;           // bf16 row stride of a w2 column slice
  static constexpr int LDW3 = KS3 + 8;           // bf16 row stride of a w1 column slice
  static constexpr size_t kT = align128((size_t)TR * LDT * 4);
  static constexpr size_t kDa = align128((size_t)TR * LDW * 2);
  static constexpr size_t kBuf = align128(cmax(cmax((size_t)KS1 * LDW * 2, (size_t)FC * LDW2 * 2),
                                               cmax((size_t)kD * LDW3 * 2, (size_t)TR * LDC * 4)));
  static constexpr size_t kSmem = 2 * kXa + kT + kDa + kStage + kStats + kBuf;
  static_assert(NJ >= 1 && FC % KS3 == 0 && kD % KS2 == 0, "chunk width");
  static_assert(kSmem <= 232448, "phase A must fit a block's shared memory");
};

template <int FC>
__global__ void __launch_bounds__(kThreads)
chanff_chunk_bwd_rows(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                      const bf16* __restrict__ w1, const float* __restrict__ b1,
                      const bf16* __restrict__ w2, bf16* __restrict__ dx,
                      bf16* __restrict__ xa_out, bf16* __restrict__ g1_out,
                      bf16* __restrict__ da1_out, float* __restrict__ part_d,
                      float* __restrict__ part_f, int R, int F) {
  using C = Bwd<FC>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* xa = reinterpret_cast<bf16*>(p);
  bf16* dys = reinterpret_cast<bf16*>(p += kXa);
  float* a1t = reinterpret_cast<float*>(p += kXa);
  bf16* da1t = reinterpret_cast<bf16*>(p += C::kT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stg = reinterpret_cast<float*>(p += C::kDa) + warp * 16 * LDS;
  float* mu_s = reinterpret_cast<float*>(p += kStage);
  float* rsig_s = mu_s + TR;
  bf16* buf = reinterpret_cast<bf16*>(p += kStats);
  float* dxa_s = reinterpret_cast<float*>(buf);  // after the loop

  const int row0 = blockIdx.x * TR;
  ln_rows<TR>(x, ln_scale, ln_bias, xa, LDA, row0, R, mu_s, rsig_s, xa_out, dy, dys);

  Acc acc[kD / (16 * kWarps)];  // dxa, this warp's 64 columns
#pragma unroll
  for (int j = 0; j < kD / (16 * kWarps); ++j) wmma::fill_fragment(acc[j], 0.0f);
  const int fcol = warp * (FC / kWarps);
  const int dcol = warp * (kD / kWarps);

  for (int f0 = 0; f0 < F; f0 += FC) {
    {  // a1 = xa @ w1[:, chunk] (bias added below), this warp's columns, into the f32 tile
      Acc h[C::NJ];
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) wmma::fill_fragment(h[j], 0.0f);
      for (int k0 = 0; k0 < kD; k0 += C::KS1) {
        __syncthreads();  // LN rows written / the buffer's last slice consumed
        stage(buf, C::LDW, w1 + (size_t)k0 * F + f0, F, C::KS1, FC);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < C::KS1; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, xa + k0 + kk, LDA);
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) {
            FragB b;
            wmma::load_matrix_sync(b, buf + kk * C::LDW + fcol + 16 * j, C::LDW);
            wmma::mma_sync(h[j], a, b, h[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        wmma::store_matrix_sync(a1t + fcol + 16 * j, h[j], C::LDT, wmma::mem_row_major);
    }
    {  // dg1 = dy @ w2[chunk, :]^T, the same columns; then da1 tile by tile
      Acc h[C::NJ];
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) wmma::fill_fragment(h[j], 0.0f);
      for (int k0 = 0; k0 < kD; k0 += C::KS2) {
        __syncthreads();
        stage(buf, C::LDW2, w2 + (size_t)f0 * kD + k0, kD, FC, C::KS2);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < C::KS2; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, dys + k0 + kk, LDA);
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) {
            FragBt b;  // w2 slice^T
            wmma::load_matrix_sync(b, buf + (fcol + 16 * j) * C::LDW2 + kk, C::LDW2);
            wmma::mma_sync(h[j], a, b, h[j]);
          }
        }
      }
      // g1 and da1 = dg1 * gelu'(a1) for this warp's columns (its own a1 tile: no
      // block barrier); scratch out in bf16; db1 partials from the f32 da1
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        wmma::store_matrix_sync(stg, h[j], LDS, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = e % 16, col = fcol + 16 * j + c;
          const int row = row0 + r;
          const float a = a1t[r * C::LDT + col] + b1[f0 + col];
          const float cdf = gelu_cdf(a);
          const float da = stg[r * LDS + c] * (cdf + a * gelu_pdf(a));
          const bf16 da_c = __float2bfloat16(da);
          stg[r * LDS + c] = da;
          da1t[r * C::LDW + col] = da_c;
          if (row < R) {
            const size_t o = (size_t)row * F + f0 + col;
            g1_out[o] = __float2bfloat16(a * cdf);
            da1_out[o] = da_c;
          }
        }
        __syncwarp();
        if (lane < 16) {
          float s = 0.0f;
#pragma unroll
          for (int r = 0; r < TR; ++r) s += stg[r * LDS + lane];
          part_f[(size_t)blockIdx.x * F + f0 + fcol + 16 * j + lane] = s;
        }
        __syncwarp();
      }
    }
    // dxa += da1 (TR, FC) @ w1[:, chunk]^T, w1 in column slices
    for (int s0 = 0; s0 < FC; s0 += C::KS3) {
      __syncthreads();  // the da1 tile complete / the buffer's last slice consumed
      stage(buf, C::LDW3, w1 + f0 + s0, F, kD, C::KS3);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < C::KS3; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, da1t + s0 + kk, C::LDW);
#pragma unroll
        for (int j = 0; j < kD / (16 * kWarps); ++j) {
          FragBt b;  // w1 slice^T
          wmma::load_matrix_sync(b, buf + (dcol + 16 * j) * C::LDW3 + kk, C::LDW3);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the buffer before dxa_s overwrites it
#pragma unroll
  for (int j = 0; j < kD / (16 * kWarps); ++j)
    wmma::store_matrix_sync(dxa_s + dcol + 16 * j, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();

  ln_bwd_rows(x, ln_scale, dxa_s, LDC, dys, LDA, mu_s, rsig_s, dx, part_d, row0, R);
}

template <int FC>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y, int R, int F,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(chanff_chunk_fwd<FC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Fwd<FC>::kSmem);
  if (err != cudaSuccess) return err;
  chanff_chunk_fwd<FC><<<(R + TR - 1) / TR, kThreads, Fwd<FC>::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y), R, F);
  return cudaGetLastError();
}

template <int FC>
cudaError_t launch_bwd(const void* x, const void* dy, const void* g, const void* b,
                       const void* w1, const void* b1, const void* w2, void* dx, void* xa,
                       void* g1, void* da1, void* part_d, void* part_f, int R, int F,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(chanff_chunk_bwd_rows<FC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Bwd<FC>::kSmem);
  if (err != cudaSuccess) return err;
  chanff_chunk_bwd_rows<FC><<<(R + TR - 1) / TR, kThreads, Bwd<FC>::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(dx), static_cast<bf16*>(xa),
      static_cast<bf16*>(g1), static_cast<bf16*>(da1), static_cast<float*>(part_d),
      static_cast<float*>(part_f), R, F);
  return cudaGetLastError();
}

bool shapes_ok(int R, int D, int F, int fc) {
  return D == kD && R > 0 && (fc == 128 || fc == 256 || fc == 512 || fc == 1024) && F > 0 &&
         F % fc == 0;
}

}  // namespace

extern "C" {

// Shapes the kernels take: D == 512, fc in {128, 256, 512, 1024}, F a multiple
// of fc, R >= 1; bf16 x, dy, w1, w2, y, dx and scratch; f32 vectors. All
// pointers 16-byte aligned and contiguous.
int pips_chanff_chunk_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* y, int R, int D, int F, int fc, int device, void* stream) {
  if (!shapes_ok(R, D, F, fc)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 128: return (int)launch_fwd<128>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, R, F, s);
    case 256: return (int)launch_fwd<256>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, R, F, s);
    case 512: return (int)launch_fwd<512>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, R, F, s);
    default: return (int)launch_fwd<1024>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, R, F, s);
  }
}

// Phase A of the backward: dx, scratch xa (R*D), g1 and da1 (R*F) in bf16 and
// the f32 partials part_d (ceil(R/16)*3*D) and part_f (ceil(R/16)*F), in
// chanff_rows.cuh's layout for pips_chanff_bwd_finish.
int pips_chanff_chunk_bwd_rows(const void* x, const void* dy, const void* ln_scale,
                               const void* ln_bias, const void* w1, const void* b1,
                               const void* w2, void* dx, void* xa, void* g1, void* da1,
                               void* part_d, void* part_f, int R, int D, int F, int fc,
                               int device, void* stream) {
  if (!shapes_ok(R, D, F, fc)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fc) {
    case 128:
      return (int)launch_bwd<128>(x, dy, ln_scale, ln_bias, w1, b1, w2, dx, xa, g1, da1, part_d,
                                  part_f, R, F, s);
    case 256:
      return (int)launch_bwd<256>(x, dy, ln_scale, ln_bias, w1, b1, w2, dx, xa, g1, da1, part_d,
                                  part_f, R, F, s);
    case 512:
      return (int)launch_bwd<512>(x, dy, ln_scale, ln_bias, w1, b1, w2, dx, xa, g1, da1, part_d,
                                  part_f, R, F, s);
    default:
      return (int)launch_bwd<1024>(x, dy, ln_scale, ln_bias, w1, b1, w2, dx, xa, g1, da1, part_d,
                                   part_f, R, F, s);
  }
}

}  // extern "C"
