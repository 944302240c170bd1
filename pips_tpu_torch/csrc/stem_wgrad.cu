// Weight gradient of the encoder stem's conv in its W-space-to-depth form:
// stride (2, 1), VALID, 7x4 taps, 6 -> 64 channels,
//   dk[o, c, ky, kx] = sum_{b, h, w'} x2[b, 2h + ky, w' + kx, c] * dy[b, h, w', o]
// with x2 (B, Hp, Wp, 6) and dy (B, Ho, Wo, 64) NHWC in memory
// (torch.channels_last), bf16 or f32 operands, f32 sums, dk f32 in
// F.conv2d's weight layout (64, 6, 7, 4).
//
// Replaces the TPU kernel pips_tpu/kernels/stem_wgrad_pallas.py:stem_wgrad
// (pallas_call of _wgrad_kernel), the weight gradient of stem_conv_s2d, in
// both dtypes JAX runs it in.
//
// What bounds it on an H100, bf16: dk is a (168 x 64) product over K = B*Ho*Wo
// pixels: 2*168*64 operations per pixel against 64 + 3 (x2 is 6 channels at
// half the rows, read once) bf16 values per pixel. At B=8, 384x512 that is
// 8.5 GFLOP (0.009 ms at 989 TFLOP/s) against 60 MB (0.018 ms at 3.35 TB/s):
// bound by bytes, dy above all. The TPU design exists to keep the row-tap
// tensor x7[b, h, w', ky*6 + c] = x2[b, 2h + ky, w', c] out of HBM; here x2 is
// read in place at row stride 2 and x7 exists only as a view of x2's rows in
// shared memory.
//
// Design, bf16 (stem_wgrad_tc): tensor cores, wgmma. dk^T (64 x 168) = dy^T
// (64 x K) X7 (K x 168) with 168 = (ky, kx, c), bf16 in and f32 sums (bf16
// products are exact in f32, so only the order of the sums differs from the
// plain version). Work is cut into segments of one output row (b, h) and up
// to kSeg columns; each persistent block (two an SM) walks a contiguous run of
// them through a ring of shared-memory stages, full/empty mbarriers each:
//   producers (two warps): dy's segment, kSeg px x 64 o contiguous in HBM, by
//       one TMA box (128-byte swizzled) on the stage's mbarrier; rows
//       2h .. 2h+6 of x2, kSeg + 3 px of six channels, by 4-byte cp.async (an
//       x2 row is Wp * 12 bytes, not a multiple of 16: no wider copy is
//       aligned, no TMA box fits) into [ky][px][8], 16 bytes a pixel,
//       channels 6 and 7 zeroed once; cp.async's arrive on the same mbarrier;
//   the consumer warpgroup: per 16 pixels, seven wgmma m64n32k16, one per
//       row tap ky. A: dy^T, by ldmatrix.trans from the dy tile into
//       registers once for the seven (from shared memory the seven would
//       fetch it seven times, and shared memory's rate would set the pace);
//       pixels past a segment's end are zeroed there. B: X7 of ky read in
//       place: for one ky, X7's 32 columns (kx, c8) of pixel p are the 32
//       values from pixel p on, so its 8 x 8 core matrices (kx, 8 pixels) lie
//       16 bytes apart along N and 128 along K of the unswizzled x tile. X7
//       never exists, not even in shared memory; the channel padding costs a
//       quarter of the tensor work (224 columns for 168), none of the bytes.
// Each block stages its 10,752 sums through shared memory and writes them
// whole (16-byte stores); a second launch adds the blocks' partials in a
// fixed order (block order within 32 runs, then the runs in order), so the
// result is deterministic without atomics.
//
// Design, f32 (stem_wgrad_f32): exact f32 FMAs on the SIMT cores (TF32 on
// the tensor cores would change the arithmetic), so bound by operations:
// 8.46 GFLOP at B=8, 384x512 is 0.126 ms at 67 TFLOP/s against 120 MB of
// x2, dy and dk (0.036 ms at 3.35 TB/s). The loop must keep the FMA pipes
// busy: few other instructions per FMA, a whole number of warps on each of
// an SM's four schedulers, and copies that land while it runs.
//   * One block an SM: 384 threads, 12 warps (three a scheduler; at 14 one
//     scheduler would hold four, and ptxas caps a thread at 128 registers),
//     and a contiguous run of segments of up to 128 columns of an output
//     row each. The host's plan (kernels/stem_wgrad_cuda.py: f32_plan)
//     narrows the segments where the rows are too few to give every SM two.
//   * A segment's dy (nw x 64 floats, contiguous) by 16-byte cp.async and
//     x2's seven rows 2h .. 2h + 6 (nw + 3 pixels of 24 bytes) by 8-byte
//     cp.async, in a ring of three stages: the next two segments land while
//     this one is computed; one __syncthreads a segment. The block walks its
//     segments with a cursor (no division in the loop).
//   * The threads are four pixel groups of 96 (three warps), each over a
//     quarter of the segment's columns and all of dk. A thread owns a
//     channel pair, one kx, the seven ky and eight outputs: 112
//     accumulators. Per column: seven LDS.64 of x (its pair at column w + kx
//     in each row) and two LDS.128 of dy, for 112 FMAs. A warp is one
//     channel pair: four kx x eight output groups, so its x loads are four
//     addresses in one 128-byte line and its dy loads one 128-byte row each.
//   * Each group's sums go to its own slot of shared memory and the block's
//     partial row is their sum in group order, written whole (16-byte
//     stores); so the second launch adds one row an SM (132 at most), in
//     block order. It is queued behind the first as a programmatic dependent
//     launch, one wave of blocks, and writes dk in its layout.

// Plain C ABI (loaded with ctypes): pips_stem_wgrad_blocks gives the number of
// partial rows of the bf16 scratch (the f32 plan is the host's);
// pips_stem_wgrad returns cudaGetLastError() after the launches; 0 means
// launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KY = 7, KX = 4, C = 6, O = 64;
constexpr int kOut = KY * KX * C * O;    // 10,752 outputs

// ---- bf16: tensor cores ----------------------------------------------------------

constexpr int kSeg = 128;                // output columns per segment
constexpr int kConsumerThreads = 128;    // one warpgroup: the products
constexpr int kProducerThreads = 64;     // two warps: the copies
constexpr int kTcThreads = kConsumerThreads + kProducerThreads;
constexpr int kStages = 3;               // ring depth
constexpr int kXRow = (kSeg + KX - 1 + 7) / 8 * 8;  // staged pixels per x row
constexpr int kDyBytes = kSeg * O * 2;   // 16,384: [px][o], 128-byte swizzled (TMA)
constexpr int kXBytes = KY * kXRow * 16; // 15,232: [ky][px][8 channels]
// 1024 bytes to align the dy tiles, the dy tiles, the x tiles, full and empty mbarriers
constexpr size_t kTcSmem =
    1024 + (size_t)kStages * (kDyBytes + kXBytes) + 2 * kStages * 8;  // 95,920: two blocks an SM
static_assert(kDyBytes % 1024 == 0 && kXBytes % 16 == 0, "stage alignment");
static_assert((size_t)kOut * 4 <= (size_t)kStages * kDyBytes, "partial sums over the dy tiles");

// the two bf16 halves of a fragment register that hold pixels k and k + 1:
// kept where the pixel is before the segment's end, zero after
__device__ __forceinline__ uint32_t keep2(int k, int nw) {
  return (k < nw ? 0x0000ffffu : 0u) | (k + 1 < nw ? 0xffff0000u : 0u);
}

// dy_map: dy as (B*Ho*Wo) rows of 64 bf16, boxes of kSeg rows
__global__ void __launch_bounds__(kTcThreads, 2)
stem_wgrad_tc(__grid_constant__ const CUtensorMap dy_map, const bf16* __restrict__ x2,
              float* __restrict__ part, int B, int Hp, int Wp, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* dys = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xss = dys + kStages * kDyBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(xss + kStages * kXBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int segs_w = (Wo + kSeg - 1) / kSeg;
  const long nseg = (long)B * Ho * segs_w;
  const long s0 = nseg * blockIdx.x / gridDim.x, s1 = nseg * (blockIdx.x + 1) / gridDim.x;
  const int n = (int)(s1 - s0);

  // channels 6 and 7 of every staged pixel stay zero: the copies write 0..5
  for (int i = tid; i < kStages * kXBytes / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(xss)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + kProducerThreads);  // the TMA's arrive, each copier's
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[KY][16];  // [ky][m64n32 C fragment]: o by warp and lane, (kx, channel 0..7)
  if (tid >= kConsumerThreads) {
    // producers: segment j into ring slot j % kStages, dy by one TMA box,
    // x's seven rows (six channels of nw + 3 pixels) by 4-byte cp.async
    const int ptid = tid - kConsumerThreads;
    for (int j = 0; j < n; ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
      const long sg = s0 + j, bh = sg / segs_w;
      const int w0 = (int)(sg % segs_w) * kSeg;
      const int h = (int)(bh % Ho), b = (int)(bh / Ho);
      const int nw = min(kSeg, Wo - w0);
      if (ptid == 0) {
        mbar_arrive_expect_tx(&full[s], kDyBytes);
        tma_load_2d(dys + s * kDyBytes, &dy_map, 0, (int)(bh * Wo + w0), &full[s]);
      }
      const int words = (nw + KX - 1) * 3;
      unsigned char* xs = xss + s * kXBytes;
      for (int r = 0; r < KY; ++r) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            x2 + (((size_t)b * Hp + 2 * h + r) * Wp + w0) * C);
        for (int q = ptid; q < words; q += kProducerThreads) {
          const int px = q / 3;
          cp_async_4(xs + (r * kXRow + px) * 16 + (q - 3 * px) * 4, src + q);
        }
      }
      cp_async_arrive_noinc(&full[s]);
    }
  } else {
    // the warpgroup: dk^T (64 x 224) += dy^T X7 on wgmma m64n32k16, one per
    // row tap and 16 pixels. A: dy^T, this warp's 16 outputs o of 16 pixels,
    // by ldmatrix.trans from the dy tile into registers once for all seven
    // row taps (read from shared memory, the seven products would fetch it
    // seven times, and shared memory's rate, not the tensor cores', would set
    // the pace); pixels past the segment's end are zeroed there. Two register
    // buffers by turns, so one step's fragments load while the step before
    // multiplies. B: X7 of row tap ky, MN-major and unswizzled, read in place
    // from the x tile: the core matrix of kx and pixels p .. p + 7 is the 128
    // bytes from pixel p + kx on, so core matrices lie 16 bytes apart along N
    // and 128 along K. A slot is released as soon as its segment's products
    // complete: a slot held longer is a copy not in flight.
#pragma unroll
    for (int ky = 0; ky < KY; ++ky)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[ky][j] = 0.0f;
    const int a_p = (lane & 7) + 8 * (lane >> 4), a_j = 2 * warp + ((lane >> 3) & 1);
    uint32_t a0[4], a1[4];
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const long sg = s0 + i;
      const int nw = min(kSeg, Wo - (int)(sg % segs_w) * kSeg);
      const unsigned char* dt = dys + s * kDyBytes;
      const unsigned char* xs = xss + s * kXBytes;
      // one 16-pixel step: its A fragment into a (free once the group two
      // steps back has completed), then the seven products as one group
      auto step = [&](int ks, uint32_t* a) {
        wgmma_wait<1>();
        ldmatrix_x4_trans(a[0], a[1], a[2], a[3],
                          reinterpret_cast<const bf16*>(dt + swz128(ks * 16 + a_p, a_j)));
        if (ks * 16 + 16 > nw) {  // the segment's last step runs past its end
          const int k = ks * 16 + 2 * (lane & 3);
          const uint32_t lo = keep2(k, nw), hi = keep2(k + 8, nw);
          a[0] &= lo;
          a[1] &= lo;
          a[2] &= hi;
          a[3] &= hi;
        }
        wgmma_fence();
#pragma unroll
        for (int ky = 0; ky < KY; ++ky)
          wgmma_m64n32k16_rs<1>(acc[ky], a,
                                gmma_desc(xs + (ky * kXRow + ks * 16) * 16, 128, 16, 0));
        wgmma_commit();
      };
      for (int ks = 0; ks * 16 < nw; ks += 2) {
        step(ks, a0);
        if ((ks + 1) * 16 < nw) step(ks + 1, a1);
      }
      wgmma_wait<0>();  // the segment's products are done: its slot is free
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // this block's partial dk in dk's layout [o][c][ky][kx], staged over the dy
  // tiles (every box and copy has landed and been read) and written whole
  __syncthreads();
  float* red = reinterpret_cast<float*>(dys);
  const int c0 = 2 * (lane & 3);
  if (tid < kConsumerThreads && c0 < C) {  // lanes holding channels 6 and 7 write nothing
#pragma unroll
    for (int ky = 0; ky < KY; ++ky)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int o = warp * 16 + lane / 4 + 8 * ((j >> 1) & 1), c = c0 + (j & 1), kx = j >> 2;
        red[((o * C + c) * KY + ky) * KX + kx] = acc[ky][j];
      }
  }
  __syncthreads();
  float4* pb = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * kOut);
  for (int i = tid; i < kOut / 4; i += kTcThreads) pb[i] = reinterpret_cast<const float4*>(red)[i];
}

// ---- f32: register-tiled SIMT -------------------------------------------------------

constexpr int kF32Seg = 128;             // output columns a segment, at most (the host's plan)
constexpr int kGroups = 4;               // pixel groups: each takes a quarter of a segment's columns
constexpr int kChT = 2;                  // a thread's channels (a pair: 0-1, 2-3 or 4-5) ...
constexpr int kOutT = 8;                 // ... its outputs, at one kx and all seven ky
constexpr int kOG = O / kOutT;           // 8 output groups
constexpr int kGroupThreads = (C / kChT) * kOG * KX;  // 96: one pixel group, the whole dk
constexpr int kF32Threads = kGroups * kGroupThreads;  // 384: 12 warps, three a scheduler
constexpr int kF32Stages = 3;            // cp.async ring depth
constexpr int kXR = kF32Seg + KX - 1 + 1;             // x's staged pixels a row (even)
constexpr int kDyFloats = kF32Seg * O;               // [px][o]
constexpr int kStageFloats = kDyFloats + KY * kXR * C;  // + [ky][px][c]: 13,736 floats
// the ring, or the groups' sums at the end (172,032 bytes): one block an SM
constexpr size_t kF32Smem = (size_t)4 * (kF32Stages * kStageFloats > kGroups * kOut
                                             ? kF32Stages * kStageFloats : kGroups * kOut);
static_assert(kXR % 2 == 0 && kStageFloats % 4 == 0, "stage alignment");
static_assert(kOut % 4 == 0, "16-byte rows of sums");
static_assert(KY * kChT * kOutT * kGroupThreads == kOut, "a group holds all of dk");

// One pixel column w of a thread: its two channels of x at column w + kx in
// the seven rows (seven LDS.64), its eight outputs of dy (two LDS.128), 112
// FMAs. xp: the thread's channel pair at kx in row 0; dp: its outputs 4og..
// and 32 + 4og.. of column 0.
__device__ __forceinline__ void f32_pixel(float (&acc)[KY][kChT][kOutT], const float* xp,
                                          const float* dp, int w) {
  float2 x[KY];
#pragma unroll
  for (int ky = 0; ky < KY; ++ky)
    x[ky] = *reinterpret_cast<const float2*>(xp + ky * kXR * C + w * C);
  const float4 d0 = *reinterpret_cast<const float4*>(dp + w * O);
  const float4 d1 = *reinterpret_cast<const float4*>(dp + w * O + 32);
  const float d[kOutT] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
  for (int ky = 0; ky < KY; ++ky)
#pragma unroll
    for (int j = 0; j < kOutT; ++j) {
      acc[ky][0][j] = fmaf(x[ky].x, d[j], acc[ky][0][j]);
      acc[ky][1][j] = fmaf(x[ky].y, d[j], acc[ky][1][j]);
    }
}

// x2 (B, Hp, Wp, 6) and dy (B, Ho, Wo, 64) f32 in memory; segments of `seg`
// columns of an output row, a block a contiguous run of them (the host's
// f32_plan); part (gridDim.x, 10752): each block's sums, laid out as
// f32_dk_index reads them
__global__ void __launch_bounds__(kF32Threads, 1)
stem_wgrad_f32(const float* __restrict__ x2, const float* __restrict__ dy,
               float* __restrict__ part, int B, int Hp, int Wp, int Ho, int Wo, int seg) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, u = tid % kGroupThreads;
  const int cp = u / 32, og = u % kOG, kx = (u % 32) / kOG;  // a warp: one channel pair
  asm volatile("griddepcontrol.launch_dependents;");  // the sums may launch (they wait for this)
  const int segs_w = (Wo + seg - 1) / seg;
  const int nseg = B * Ho * segs_w;
  const int s0 = (int)((long)nseg * blockIdx.x / gridDim.x);
  const int s1 = (int)((long)nseg * (blockIdx.x + 1) / gridDim.x);
  const int nsegs = s1 - s0;

  // segment j of the block (j = 0, 1, ... in turn: the cursor lc, lh, lb
  // steps along, no division) into ring slot j % kF32Stages: dy's nw x 64
  // floats (contiguous) by 16-byte copies, x2's seven rows 2h .. 2h + 6 of
  // nw + 3 pixels (24 bytes each, 8-byte aligned) by 8-byte copies. The
  // loops stay rolled (unrolled, ptxas holds their addresses in registers).
  int lc = s0 % segs_w, lh = s0 / segs_w % Ho, lb = s0 / segs_w / Ho;
  auto load = [&](int j) {
    float* st = sm + (j % kF32Stages) * kStageFloats;
    const int w0 = lc * seg, nw = min(seg, Wo - w0);
    const float* dsrc = dy + (((size_t)lb * Ho + lh) * Wo + w0) * O;
#pragma unroll 1
    for (int i = tid; i < nw * (O / 4); i += kF32Threads)
      cp_async_16z(st + 4 * i, dsrc + 4 * i, true);
    const int words = (nw + KX - 1) * (C / 2);
    const float* xsrc = x2 + (((size_t)lb * Hp + 2 * lh) * Wp + w0) * C;
#pragma unroll 1
    for (int r = 0; r < KY; ++r)
#pragma unroll 1
      for (int k = tid; k < words; k += kF32Threads)
        cp_async_8(st + kDyFloats + r * kXR * C + 2 * k, xsrc + (size_t)r * Wp * C + 2 * k);
    if (++lc == segs_w) {
      lc = 0;
      if (++lh == Ho) lh = 0, ++lb;
    }
  };

  float acc[KY][kChT][kOutT];
#pragma unroll
  for (int ky = 0; ky < KY; ++ky)
#pragma unroll
    for (int c = 0; c < kChT; ++c)
#pragma unroll
      for (int j = 0; j < kOutT; ++j) acc[ky][c][j] = 0.0f;

#pragma unroll 1
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < nsegs) load(j);
    cp_async_commit();
  }
  int cc = s0 % segs_w;  // segment i's column chunk
#pragma unroll 1
  for (int i = 0; i < nsegs; ++i) {
    cp_async_wait<kF32Stages - 2>();  // this thread's copies of segment i have landed
    __syncthreads();                  // every thread's have, and every thread is past i - 1
    if (i + kF32Stages - 1 < nsegs) load(i + kF32Stages - 1);
    cp_async_commit();
    const float* st = sm + (i % kF32Stages) * kStageFloats;
    const int nw = min(seg, Wo - cc * seg);
    if (++cc == segs_w) cc = 0;
    const int c0 = nw * g / kGroups, c1 = nw * (g + 1) / kGroups;  // this group's columns
    const float* xp = st + kDyFloats + kx * C + kChT * cp;
    const float* dp = st + 4 * og;
    int w = c0;
#pragma unroll 1
    for (; w + 2 <= c1; w += 2) {
      f32_pixel(acc, xp, dp, w);
      f32_pixel(acc, xp, dp, w + 1);
    }
    if (w < c1) f32_pixel(acc, xp, dp, w);
  }

  // each group's sums into its slot of shared memory, laid [accumulator]
  // [thread of the group] (f32_dk_index maps that to dk's layout); then the
  // block's partial row, each float4 of it the four slots added in group
  // order, written whole (16-byte stores)
  cp_async_wait<0>();
  __syncthreads();
  float* slot = sm + g * kOut;
#pragma unroll
  for (int ky = 0; ky < KY; ++ky)
#pragma unroll
    for (int c = 0; c < kChT; ++c)
#pragma unroll
      for (int j = 0; j < kOutT; ++j)
        slot[((ky * kChT + c) * kOutT + j) * kGroupThreads + u] = acc[ky][c][j];
  __syncthreads();
  float4* pb = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * kOut);
  for (int i = tid; i < kOut / 4; i += kF32Threads) {
    float4 v = reinterpret_cast<const float4*>(sm)[i];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) {
      const float4 w = reinterpret_cast<const float4*>(sm + q * kOut)[i];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    pb[i] = v;
  }
}

// ---- the blocks' partials, summed --------------------------------------------------

constexpr int kSumCols = 32, kSumRuns = 32;  // a block: 32 outputs, 32 runs of blocks each
constexpr int kF32SumCols = 32, kF32SumRuns = 16;  // f32 (a row an SM at most): one wave

// where stem_wgrad_f32's partial row keeps output i of dk: at accumulator
// ((ky * 2 + c % 2) * 8 + j) of thread (c / 2) * 32 + kx * 8 + og of a group,
// o = 4 og + j % 4 + 32 (j / 4)
__device__ __forceinline__ int f32_dk_index(int i) {
  const int j = i / kGroupThreads, u = i % kGroupThreads;
  const int cp = u / 32, kx = u % 32 / kOG, og = u % kOG;
  const int ky = j / (kChT * kOutT), c = kChT * cp + j / kOutT % kChT, jj = j % kOutT;
  const int o = (jj < 4 ? 0 : 32) + 4 * og + (jj & 3);
  return ((o * C + c) * KY + ky) * KX + kx;
}

// dk = the sum over the partial blocks, each of RUNS runs of blocks summed
// in block order, then the runs in order: a fixed order. F32: the
// partial rows in stem_wgrad_f32's layout; launched as its programmatic
// dependent, waiting here for its partials
template <bool F32, int COLS, int RUNS>
__global__ void __launch_bounds__(COLS * RUNS)
stem_wgrad_sum(const float* __restrict__ part, float* __restrict__ dk, int nblocks) {
  if (F32) asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float runs[RUNS][COLS];
  const int col = threadIdx.x % COLS, r = threadIdx.x / COLS;
  const int i = blockIdx.x * COLS + col;
  const int k0 = nblocks * r / RUNS, k1 = nblocks * (r + 1) / RUNS;
  float v = 0.0f;
  if (i < kOut) {
#pragma unroll 8
    for (int k = k0; k < k1; ++k) v += part[(size_t)k * kOut + i];
  }
  runs[r][col] = v;
  __syncthreads();
  if (r == 0 && i < kOut) {
#pragma unroll
    for (int q = 1; q < RUNS; ++q) v += runs[q][col];
    dk[F32 ? f32_dk_index(i) : i] = v;
  }
}

cudaError_t tc_config() {
  return cudaFuncSetAttribute(stem_wgrad_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kTcSmem);
}

}  // namespace

extern "C" {

// Blocks of the bf16 launch, so rows of the scratch (nblocks, 10752) f32: as
// many as fit the card at once, at most one per segment of kSeg columns (the
// f32 launch is laid out by the host: kernels/stem_wgrad_cuda.py: f32_plan).
int pips_stem_wgrad_blocks(int B, int Ho, int Wo, int device) {
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      tc_config() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_wgrad_tc, kTcThreads,
                                                    kTcSmem) != cudaSuccess)
    return -1;
  const long nseg = (long)B * Ho * ((Wo + kSeg - 1) / kSeg);
  const long resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(nseg < resident ? nseg : resident);
}

// Shapes the kernel takes: x2 (B, 6, Hp, Wp) and dy (B, 64, Ho, Wo), both
// contiguous NHWC in memory (torch.channels_last), one dtype; Hp >= 2*Ho + 5,
// Wp >= Wo + 3; dk (64, 6, 7, 4) float32; part (nblocks, 10752) float32;
// pointers 16-byte aligned. dtype_code 1 = bfloat16: seg = 128 and nblocks
// from pips_stem_wgrad_blocks; 0 = float32: seg (1 .. 128 output columns a
// segment) and nblocks (at most the segments) from the host's f32_plan.
int pips_stem_wgrad(const void* x2, const void* dy, void* dk, void* part, int nblocks, int seg,
                    int B, int Hp, int Wp, int Ho, int Wo, int dtype_code, int device,
                    void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Hp < 2 * Ho + KY - 2 || Wp < Wo + KX - 1 || nblocks <= 0 ||
      (dtype_code == 1 && seg != kSeg) ||
      (dtype_code == 0 &&
       (seg < 1 || seg > kF32Seg || nblocks > (long)B * Ho * ((Wo + seg - 1) / seg))) ||
      (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype_code == 1) {
    err = tc_config();
    if (err != cudaSuccess) return (int)err;
    CUtensorMap dy_map;
    err = make_map_2d_bf16(&dy_map, dy, O, (uint64_t)B * Ho * Wo, O * 2, kSeg);
    if (err != cudaSuccess) return (int)err;
    stem_wgrad_tc<<<nblocks, kTcThreads, kTcSmem, s>>>(dy_map, static_cast<const bf16*>(x2), p,
                                                       B, Hp, Wp, Ho, Wo);
  } else {
    err = cudaFuncSetAttribute(stem_wgrad_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kF32Smem);
    if (err != cudaSuccess) return (int)err;
    stem_wgrad_f32<<<nblocks, kF32Threads, kF32Smem, s>>>(static_cast<const float*>(x2),
                                                          static_cast<const float*>(dy), p, B, Hp,
                                                          Wp, Ho, Wo, seg);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype_code == 1) {
    stem_wgrad_sum<false, kSumCols, kSumRuns>
        <<<(kOut + kSumCols - 1) / kSumCols, kSumCols * kSumRuns, 0, s>>>(
            p, static_cast<float*>(dk), nblocks);
    return (int)cudaGetLastError();
  }
  // f32: queued while the partial launch runs (programmatic dependent launch)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((kOut + kF32SumCols - 1) / kF32SumCols);
  cfg.blockDim = dim3(kF32SumCols * kF32SumRuns);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stem_wgrad_sum<true, kF32SumCols, kF32SumRuns>,
                           static_cast<const float*>(p),
                           static_cast<float*>(dk), nblocks);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
