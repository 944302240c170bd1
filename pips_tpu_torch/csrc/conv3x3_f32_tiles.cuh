// The f32 3x3 convolutions' mainloop, shared by conv3x3_fwd.cu (conv3x3_f32:
// the encoder's stage-1 convs and their dx in an f32 model) and
// conv3x3_stats.cu (conv3x3_stats_f32: the residual block's conv pass), as
// conv3x3_tiles.cuh is the bf16 kernels' mainloop.
//
// What bounds it on an H100: the products, 2*576 FLOP per (pixel, output),
// on the FMA units at 67 TFLOP/s (f32 operands on the tensor cores would be
// TF32, which keeps 10 mantissa bits and fails the f32 reference); the bytes
// (x read once, y written once, f32) take a tenth of that time. So the loop
// must keep the FMA pipes busy: few other instructions per FMA, shared-memory
// loads well inside the shared pipe's rate, and enough warps on every SM.
//
// Design: an implicit GEMM with the input's haloed box in shared memory.
//   * A block of 256 threads computes an output tile of TH x TW = 8 x 32
//     pixels times OG = 8 PX outputs. A thread owns PX adjacent pixels of a
//     row times 8 outputs: at OG = 64, 8 x 8 = 64 accumulators. The host's
//     plan takes OG = 32, 16 or 8 (a run of 4, 2 or 1 pixels) where the
//     image has too few tiles to fill the card: more blocks, each as wide.
//     A warp's lanes are 32 runs of the tile, row-fastest, and share 8
//     outputs, so its weight loads are broadcasts.
//   * The box is staged as planes of 4 channels, a pixel's 4 channels one
//     16-byte slot (rows of 35 slots, odd, so that a quarter warp's loads of
//     8 rows hit 8 distinct bank groups). For each (plane, kernel row) a
//     thread loads the row's PX + 2 pixels by one LDS.128 each and uses them
//     for 4 channels x 3 column taps; per (channel, tap) two broadcast
//     LDS.128 bring its 8 weights. At PX = 8 that is 768 FMAs for 34 shared
//     loads.
//   * Channels arrive in chunks of CC = 8 through a ring of kStages = 3
//     cp.async stages: chunk k + 2's haloed box (2 planes x 10 x 34 pixels,
//     16 bytes a copy: a warp reads 16 whole 32-byte pixels; planes 356
//     slots apart, 4 mod 8, so that a quarter warp's copies land in 8 bank
//     groups) and its weights (each output's 72 contiguous floats of w (O,
//     C, 3, 3); a warp copies 8 of them for 4 outputs, 4 bytes a copy,
//     staged [tap of the chunk][output] in rows of OG + 4 floats, 4 mod 32:
//     into 32 banks, and a load's offset a constant of its tap) are in
//     flight while chunk k runs. The copy loops stay rolled, their indices
//     stepped: unrolled, their addresses are invariant across the chunks,
//     and ptxas kept them all in registers and spilled. One __syncthreads a
//     chunk.
//   * An optional prologue rewrites the thread's own copies of a chunk in
//     place once they have landed, before the chunk's barrier (conv_pass's
//     relu(x * scale + shift) on the in-image pixels; the zero padding, a
//     zero-filled copy, stays zero).
//   * Each output is summed by one thread in one order: plane of 4
//     channels, kernel row, channel, kernel column. No split of the channels
//     across blocks, no atomics: the same bits every call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {
namespace conv3f {

constexpr int kC = 64;        // channels and outputs at most
constexpr int TH = 8;         // output tile rows
constexpr int TW = 32;        // output tile columns
constexpr int OT = 8;         // a thread's outputs (a warp's)
constexpr int CC = 8;         // input channels a stage
constexpr int kStages = 3;    // cp.async stages in flight
constexpr int kThreads = TH * TW;         // 256: a thread a pixel of the tile at 8 outputs
constexpr int HR = TH + 2, HC = TW + 2;   // the haloed box: 10 x 34 pixels
// The box in shared memory: CC / 4 planes of 4 channels; a plane's pixel
// is 16 bytes (its 4 channels), a row LDX pixels (odd: the 8 rows a quarter
// warp reads land in 8 distinct 16-byte bank groups), a plane kPlane pixels
// (4 mod 8: a quarter warp's copies of 4 pixels of both planes, too)
constexpr int LDX = HC + 1;                                  // 35
constexpr int kPlane = HR * LDX + (12 - HR * LDX % 8) % 8;   // 356
constexpr int kXFloats = CC / 4 * kPlane * 4;                // a stage's box: 2848 floats
static_assert(kPlane % 8 == 4 && LDX % 2 == 1 && CC % 4 == 0, "bank spread");

// a block of OG outputs: a run of OG / 8 pixels a thread
__host__ __device__ constexpr int run(int og) { return og / OT; }
// a weight chunk's row (a tap of a channel): og outputs and 4 floats of
// padding, 4 mod 32, so that a warp's copies of 8 rows x 4 outputs hit 32
// banks and every load's offset within a chunk is a constant
__host__ __device__ constexpr int w_ld(int og) { return og + 4; }
__host__ __device__ constexpr int w_floats(int og) { return CC * 9 * w_ld(og); }
// the dynamic shared memory of a block of og outputs: kStages boxes and weight chunks
__host__ __device__ constexpr size_t smem_bytes(int og) {
  return (size_t)kStages * (kXFloats + w_floats(og)) * 4;
}
// output tiles per image: the rows of partial statistics of conv_pass
__host__ __device__ constexpr int tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

struct Tile {
  int b, ti, h0, w0, o0;  // image, tile of the image, first row, column and output
};

// block blockIdx.x: tile blockIdx.x / groups (row-major over each image's
// tiles, images in order), output group blockIdx.x % groups (og outputs each)
__device__ __forceinline__ Tile tile_of(int H, int W, int og, int groups) {
  const int tiles_w = (W + TW - 1) / TW, per_image = tiles(H, W);
  const int tile = blockIdx.x / groups;
  Tile t;
  t.b = tile / per_image;
  t.ti = tile % per_image;
  t.h0 = t.ti / tiles_w * TH;
  t.w0 = t.ti % tiles_w * TW;
  t.o0 = blockIdx.x % groups * og;
  return t;
}

// This thread's place in a block of OG outputs: its row and first column in
// the tile (a run of OG / 8 pixels; runs row-fastest, so that a quarter
// warp's lanes are 8 rows) and its 8 outputs' first, in the block. The 8 /
// run warps of an output group are consecutive.
template <int OG>
struct Thread {
  static constexpr int PX = run(OG);
  static constexpr int kWarpsPerGroup = kThreads * OT / OG / 32;
  int r, c, o;
  __device__ __forceinline__ Thread() {
    const int warp = threadIdx.x / 32;
    const int k = warp % kWarpsPerGroup * 32 + threadIdx.x % 32;  // the run
    r = k % TH;
    c = k / TH * PX;
    o = warp / kWarpsPerGroup * OT;
  }
};

// This thread's copies of the haloed box of channels c0 .. c0 + CC - 1, 16
// bytes (4 channels) each: its plane threadIdx.x % 2 of box pixels
// threadIdx.x / 2, + kThreads / 2, ... (a warp's copy reads 16 whole 32-byte
// pixels): fn(floats into the stage, element of x, in the image, first
// channel). The pixel's row and column are stepped, not divided out.
template <class Fn>
__device__ __forceinline__ void for_box(const Tile& t, int H, int W, int Cin, int c0, Fn fn) {
  constexpr int kStep = kThreads / (CC / 4);  // pixels between a thread's copies
  const int c4 = threadIdx.x % (CC / 4);
  int r = threadIdx.x / (CC / 4) / HC, col = threadIdx.x / (CC / 4) % HC;
#pragma unroll 1
  for (int p = threadIdx.x / (CC / 4); p < HR * HC; p += kStep) {
    const int h = t.h0 - 1 + r, wc = t.w0 - 1 + col;
    const bool in = h >= 0 && h < H && wc >= 0 && wc < W;
    const size_t src = in ? (((size_t)t.b * H + h) * W + wc) * Cin + c0 + 4 * c4 : 0;
    fn((c4 * kPlane + r * LDX + col) * 4, src, in, c0 + 4 * c4);
    r += kStep / HC;
    col += kStep % HC;
    if (col >= HC) {
      col -= HC;
      ++r;
    }
  }
}

// a chunk's copies into stage (xs, ws): the box (zeros outside the image, the
// SAME padding) and the weights of outputs o0 .. o0 + OG - 1 (zeros past Cout)
template <int OG>
__device__ __forceinline__ void stage(float* xs, float* ws, const float* __restrict__ x,
                                      const float* __restrict__ w, const Tile& t, int H, int W,
                                      int Cin, int Cout, int c0) {
  for_box(t, H, W, Cin, c0,
          [&](int dst, size_t src, bool in, int) { cp_async_16z(xs + dst, x + src, in); });
  // element (ol, q) of the chunk is w[o0 + ol][c0 + q / 9][q % 9]. Warp u
  // copies rows q = 8 qh + lane / 4 of outputs ol = 4 oh + lane % 4 (32
  // contiguous bytes of each of 4 outputs), (oh, qh) = (u / 9, u % 9). u
  // steps by the 8 warps: qh by 8 = 9 - 1, so qh - 1 and oh + 1, or qh = 8
  // where qh was 0; the copy's source and destination step with them
  static_assert(CC * 9 == 8 * 9 && kThreads / 32 == 8, "9 blocks of 8 rows; 8 warps");
  const int a = threadIdx.x / 4 % 8, b = threadIdx.x % 4;
  int u = threadIdx.x / 32, qh = u;  // oh = 0
  const int oh_end = (Cout - t.o0 - b + 3) / 4;  // outputs 4 oh + b below Cout
  const size_t row = (size_t)Cin * 9;  // an output's floats in w
  size_t src = (t.o0 + b) * row + c0 * 9 + 8 * qh + a;
  int dst = (8 * qh + a) * w_ld(OG) + b, oh = 0;
#pragma unroll 1
  for (; u < CC * 9 * OG / 32; u += 8) {
    const bool ok = oh < oh_end;
    cp_async_4z(ws + dst, w + (ok ? src : 0), ok);
    if (qh > 0) {
      --qh;
      ++oh;
      src += 4 * row - 8;
      dst += 4 - 8 * w_ld(OG);
    } else {
      qh = 8;
      src += 64;
      dst += 64 * w_ld(OG);
    }
  }
}

// acc[p][o] += the chunk's products for this thread's pixels and outputs:
// for each plane and kernel row, the row's PX + 2 pixels by one LDS.128 each
// (4 channels), then per channel and column tap 8 weights by two broadcast
// LDS.128 and PX x 8 FMAs
template <int OG>
__device__ __forceinline__ void fma_chunk(float (&acc)[run(OG)][OT], const Thread<OG>& th,
                                          const float* xs, const float* ws) {
  constexpr int PX = run(OG);
  const float4* xr = reinterpret_cast<const float4*>(xs) + th.r * LDX + th.c;
  const float* wr = ws + th.o;
#pragma unroll 2  // two at once: one row's loads overlap the other's products
  for (int g = 0; g < CC / 4 * 3; ++g) {  // (plane, kernel row)
    const int c4 = g / 3, ky = g % 3;
    float xv[PX + 2][4];
#pragma unroll
    for (int i = 0; i < PX + 2; ++i) {
      const float4 v = xr[c4 * kPlane + ky * LDX + i];
      xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
    }
    const float* wg = wr + (c4 * 4 * 9 + ky * 3) * w_ld(OG);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wq = wg + (kk * 9 + kx) * w_ld(OG);
        const float4 w0 = *reinterpret_cast<const float4*>(wq);
        const float4 w1 = *reinterpret_cast<const float4*>(wq + 4);
        const float wv[OT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < PX; ++p)
#pragma unroll
          for (int o = 0; o < OT; ++o) acc[p][o] = fmaf(xv[p + kx][kk], wv[o], acc[p][o]);
      }
  }
}

// The mainloop: acc = this thread's sums over the Cin channels (a multiple
// of CC) for its pixels and 8 outputs. prologue(xs, c0) may rewrite this
// thread's own copies of a landed chunk (for_box's elements) in place.
// smem: kStages boxes, then kStages weight chunks. Ends with every thread's
// copies landed; other warps may still be reading the last chunk.
template <int OG, class Prologue>
__device__ __forceinline__ void mainloop(float (&acc)[run(OG)][OT], const Thread<OG>& th,
                                         float* smem, const float* __restrict__ x,
                                         const float* __restrict__ w, const Tile& t, int H,
                                         int W, int Cin, int Cout, Prologue prologue) {
  float* xs = smem;
  float* ws = smem + kStages * kXFloats;
  const int steps = Cin / CC;
#pragma unroll
  for (int p = 0; p < run(OG); ++p)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[p][o] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      stage<OG>(xs + s * kXFloats, ws + s * w_floats(OG), x, w, t, H, W, Cin, Cout, s * CC);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int slot = i % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    prologue(xs + slot * kXFloats, i * CC);
    __syncthreads();  // every thread's have, and every thread is past chunk i - 1
    const int next = i + kStages - 1;
    if (next < steps) {  // into chunk i - 1's slot, free past the barrier
      const int ns = next % kStages;
      stage<OG>(xs + ns * kXFloats, ws + ns * w_floats(OG), x, w, t, H, W, Cin, Cout,
                next * CC);
    }
    cp_async_commit();
    fma_chunk<OG>(acc, th, xs + slot * kXFloats, ws + slot * w_floats(OG));
  }
}

}  // namespace conv3f
}  // namespace
