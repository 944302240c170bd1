// The mainloop that the bf16 3x3 conv kernels on wgmma share
// (conv3x3_fwd.cu's conv3x3_wgmma, conv3x3_stats.cu's conv3x3_stats_bf16): a
// 3x3, stride-1, SAME 64 -> 64 convolution over NHWC as an implicit GEMM,
// y^T (64 outputs x N box pixels) = W^T X, K = 9 taps x 64 channels.
//   * The input arrives as haloed boxes of (TH + 2) rows x 32 pixels, one TMA
//     load each (a 4D tensor map over the NHWC input, 128-byte swizzled,
//     pixels outside the image read as zero: the SAME padding). A box row of
//     32 pixels holds 30 outputs; the products take all 32 columns of the
//     tile's TH rows as N = 32 TH pixels, so every tap shifts them alike and
//     the two last columns of a row are products that are no outputs.
//   * The weight stays resident as A: [tap][o][c] K-major, each tap's 64 rows
//     of 128 bytes swizzled as TMA would write them (stage_weight).
//   * products<N>: per (tap, 16 channels) one wgmma m64nNk16, all 36 issued
//     at once, both operands from shared memory. B is the box's pixel rows
//     shifted by the tap, straight from the swizzled box: the swizzle follows
//     the shared-memory address, so a descriptor may start at any pixel row.
// The caller fences, commits and waits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {
namespace conv3 {

constexpr int kC = 64;                 // input channels = outputs = 64
constexpr int kBoxCols = 32;           // a box row: 32 pixels of 128 bytes
constexpr size_t kWBytes = 9 * 64 * 128;  // 73,728: the weight as [tap][o][c]

// the weight (O, C, 3, 3) = (64, 64, 3, 3) bf16 into ws as [tap][o][c]
// K-major swizzled rows, by threads tid = 0 .. nthreads - 1 with 16-byte
// loads (eight consecutive (c, tap) of one output o: 576 = 72 * 8)
__device__ __forceinline__ void stage_weight(unsigned char* ws, const __nv_bfloat16* w, int tid,
                                             int nthreads) {
  for (int q = tid; q < 9 * kC * kC / 8; q += nthreads) {
    const uint4 u = reinterpret_cast<const uint4*>(w)[q];
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&u);
    const int o = q / 72, e = (q % 72) * 8;
    int c = e / 9, tap = e % 9;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<__nv_bfloat16*>(ws + tap * (kC * 128) + swz128(o, c / 8) + (c % 8) * 2) =
          v[k];
      if (++tap == 9) {
        tap = 0;
        ++c;
      }
    }
  }
}

// one product of 64 outputs x N pixels x 16 channels
template <int N>
__device__ __forceinline__ void product(float* acc, uint64_t a, uint64_t b) {
  static_assert(N == 128 || N == 192 || N == 256, "a box of 4, 6 or 8 output rows");
  if constexpr (N == 128) wgmma_m64n128k16<0, 0>(acc, a, b);
  if constexpr (N == 192) wgmma_m64n192k16<0, 0>(acc, a, b);
  if constexpr (N == 256) wgmma_m64n256k16<0, 0>(acc, a, b);
}

// acc (this thread's N / 2 accumulators: 4 n + 2 hi + e is output
// 16 (warp % 4) + lane / 4 + 8 hi at box pixel 8 n + 2 (lane % 4) + e) +=
// the 36 products of the box at st against the weight at ws
template <int N>
__device__ __forceinline__ void products(float* acc, const unsigned char* ws,
                                         const unsigned char* st) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < kC / 16; ++kc)
      product<N>(acc, gmma_desc(ws + tap * (kC * 128) + kc * 32, 16, 1024, 128),
                 gmma_desc(st + (ky * kBoxCols + kx) * 128 + kc * 32, 16, 1024, 128));
  }
}

}  // namespace conv3
}  // namespace
