// Weight gradient of the encoder stem's conv in its W-space-to-depth form:
// stride (2, 1), VALID, 7x4 taps, 6 -> 64 channels,
//   dk[o, c, ky, kx] = sum_{b, h, w'} x2[b, 2h + ky, w' + kx, c] * dy[b, h, w', o]
// with x2 (B, Hp, Wp, 6) and dy (B, Ho, Wo, 64) NHWC in memory
// (torch.channels_last), bf16 or f32 operands, f32 sums, dk f32 in
// F.conv2d's weight layout (64, 6, 7, 4).
//
// Replaces the TPU kernel pips_tpu/kernels/stem_wgrad_pallas.py:stem_wgrad
// (pallas_call of _wgrad_kernel), the weight gradient of stem_conv_s2d.
//
// What bounds it on an H100: dk is a (168 x 64) product over K = B*Ho*Wo
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
// Design, f32 (stem_wgrad_partial): SIMT. Segments as above; each block stages
// the seven input rows and the segment's dy in shared memory as f32, then each
// of its 336 threads owns one (ky, c) and 8 outputs o for all four kx: per
// column it slides a four-value window of x along the row (one new load) and
// reads eight dy values, for 32 FMAs. It writes its partial sums directly.
//
// Plain C ABI (loaded with ctypes): pips_stem_wgrad_blocks gives the number of
// partial rows of the scratch; pips_stem_wgrad returns cudaGetLastError()
// after the launches; 0 means launched.

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

// ---- f32: SIMT ---------------------------------------------------------------------

constexpr int SW = 128;                  // output columns per segment
constexpr int XW = SW + KX - 1;          // input columns staged per segment
constexpr int kRows = KY * C;            // 42 (ky, c) pairs
constexpr int kOG = 8;                   // outputs per thread
constexpr int kThreads = kRows * (O / kOG);  // 336
constexpr size_t kXsBytes = (size_t)KY * XW * C * 4;  // 22,008: [ky][w][c] f32
constexpr size_t kDsBytes = (size_t)SW * O * 4;       // 32,768: [w][o] f32
constexpr size_t kSmem = kDsBytes + kXsBytes;         // 54,776
static_assert(kDsBytes % 16 == 0, "dy stage alignment");

__global__ void __launch_bounds__(kThreads, 2)
stem_wgrad_partial(const float* __restrict__ x2, const float* __restrict__ dy,
                   float* __restrict__ part, int B, int Hp, int Wp, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem);             // [SW][O]
  float* xs = reinterpret_cast<float*>(smem + kDsBytes);  // [KY][XW][C]

  const int tid = threadIdx.x;
  const int og = tid % (O / kOG), rc = tid / (O / kOG);  // outputs og*8.., row (ky, c)
  const int ky = rc / C, c = rc % C;
  const int segs_w = (Wo + SW - 1) / SW;
  const long nseg = (long)B * Ho * segs_w;
  const long s0 = nseg * blockIdx.x / gridDim.x, s1 = nseg * (blockIdx.x + 1) / gridDim.x;

  float acc[KX][kOG];
#pragma unroll
  for (int kx = 0; kx < KX; ++kx)
#pragma unroll
    for (int j = 0; j < kOG; ++j) acc[kx][j] = 0.0f;

  for (long sg = s0; sg < s1; ++sg) {
    const int w0 = (int)(sg % segs_w) * SW;
    const long bh = sg / segs_w;
    const int h = (int)(bh % Ho), b = (int)(bh / Ho);
    const int nw = min(SW, Wo - w0);  // output columns of this segment
    __syncthreads();  // the previous segment is consumed

    // dy row (b, h), columns w0 .. w0+SW-1: 8 channels per item, zeros past Wo
    const float* dyr = dy + (((size_t)b * Ho + h) * Wo + w0) * O;
    for (int i = tid; i < SW * (O / 8); i += kThreads) {
      const int w = i / (O / 8), k = (i % (O / 8)) * 8;
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
      if (w < nw) {
        v0 = *reinterpret_cast<const float4*>(dyr + (size_t)w * O + k);
        v1 = *reinterpret_cast<const float4*>(dyr + (size_t)w * O + k + 4);
      }
      float4* d = reinterpret_cast<float4*>(ds + w * O + k);
      d[0] = v0;
      d[1] = v1;
    }
    // the seven input rows 2h + ky, columns w0 .. w0+XW-1 (six contiguous
    // channels each); columns past the segment's last tap read as zero
    for (int i = tid; i < KY * XW * C; i += kThreads) {
      const int r = i / (XW * C), rest = i % (XW * C);
      const int w = rest / C;
      float v = 0.0f;
      if (w < nw + KX - 1) v = x2[(((size_t)b * Hp + 2 * h + r) * Wp + w0) * C + rest];
      xs[i] = v;
    }
    __syncthreads();

    const float* xr = xs + ky * XW * C + c;
    float win[KX];
#pragma unroll
    for (int kx = 0; kx < KX - 1; ++kx) win[kx + 1] = xr[kx * C];
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
#pragma unroll
      for (int kx = 0; kx < KX - 1; ++kx) win[kx] = win[kx + 1];
      win[KX - 1] = xr[(w + KX - 1) * C];
      const float4 d0 = *reinterpret_cast<const float4*>(ds + w * O + og * kOG);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + w * O + og * kOG + 4);
      const float d[kOG] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int kx = 0; kx < KX; ++kx)
#pragma unroll
        for (int j = 0; j < kOG; ++j) acc[kx][j] = fmaf(win[kx], d[j], acc[kx][j]);
    }
  }

  // this block's partial dk in dk's layout [o][c][ky][kx]
  float* pb = part + (size_t)blockIdx.x * kOut;
#pragma unroll
  for (int j = 0; j < kOG; ++j) {
    const int o = og * kOG + j;
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) pb[((o * C + c) * KY + ky) * KX + kx] = acc[kx][j];
  }
}

// ---- the blocks' partials, summed --------------------------------------------------

constexpr int kSumCols = 32, kSumRuns = 32;  // a block: 32 outputs, 32 runs of blocks each

// dk[i] = the sum over the partial blocks, each of kSumRuns runs of blocks
// summed in block order, then the runs in order: a fixed order
__global__ void __launch_bounds__(kSumCols * kSumRuns)
stem_wgrad_sum(const float* __restrict__ part, float* __restrict__ dk, int nblocks) {
  __shared__ float runs[kSumRuns][kSumCols];
  const int col = threadIdx.x % kSumCols, r = threadIdx.x / kSumCols;
  const int i = blockIdx.x * kSumCols + col;
  const int k0 = nblocks * r / kSumRuns, k1 = nblocks * (r + 1) / kSumRuns;
  float v = 0.0f;
  if (i < kOut) {
#pragma unroll 8
    for (int k = k0; k < k1; ++k) v += part[(size_t)k * kOut + i];
  }
  runs[r][col] = v;
  __syncthreads();
  if (r == 0 && i < kOut) {
#pragma unroll
    for (int q = 1; q < kSumRuns; ++q) v += runs[q][col];
    dk[i] = v;
  }
}

cudaError_t partial_config(int dtype_code, const void** fn, int* threads, size_t* smem) {
  if (dtype_code == 1) {
    *fn = reinterpret_cast<const void*>(stem_wgrad_tc);
    *threads = kTcThreads;
    *smem = kTcSmem;
  } else {
    *fn = reinterpret_cast<const void*>(stem_wgrad_partial);
    *threads = kThreads;
    *smem = kSmem;
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" {

// Blocks of the partial launch, so rows of the scratch (nblocks, 10752) f32:
// as many as fit the card at once, at most one per segment.
// dtype_code 0 = float32, 1 = bfloat16.
int pips_stem_wgrad_blocks(int B, int Ho, int Wo, int dtype_code, int device) {
  int sms = 0, per_sm = 0, threads = 0;
  const void* fn = nullptr;
  size_t smem = 0;
  if ((dtype_code != 0 && dtype_code != 1) || cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      partial_config(dtype_code, &fn, &threads, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem) != cudaSuccess)
    return -1;
  const int seg = dtype_code == 1 ? kSeg : SW;
  const long nseg = (long)B * Ho * ((Wo + seg - 1) / seg);
  const long resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(nseg < resident ? nseg : resident);
}

// Shapes the kernel takes: x2 (B, 6, Hp, Wp) and dy (B, 64, Ho, Wo), both
// contiguous NHWC in memory (torch.channels_last), one dtype; Hp >= 2*Ho + 5,
// Wp >= Wo + 3; dk (64, 6, 7, 4) float32; part (nblocks, 10752) float32 with
// nblocks from pips_stem_wgrad_blocks for the same dtype; pointers 16-byte
// aligned. dtype_code 0 = float32, 1 = bfloat16 (x2, dy).
int pips_stem_wgrad(const void* x2, const void* dy, void* dk, void* part, int nblocks, int B,
                    int Hp, int Wp, int Ho, int Wo, int dtype_code, int device, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Hp < 2 * Ho + KY - 2 || Wp < Wo + KX - 1 || nblocks <= 0 ||
      (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = nullptr;
  int threads = 0;
  size_t smem = 0;
  err = partial_config(dtype_code, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  float* p = static_cast<float*>(part);
  if (dtype_code == 1) {
    CUtensorMap dy_map;
    err = make_map_2d_bf16(&dy_map, dy, O, (uint64_t)B * Ho * Wo, O * 2, kSeg);
    if (err != cudaSuccess) return (int)err;
    stem_wgrad_tc<<<nblocks, threads, smem, s>>>(dy_map, static_cast<const bf16*>(x2), p, B, Hp,
                                                 Wp, Ho, Wo);
  } else
    stem_wgrad_partial<<<nblocks, threads, smem, s>>>(static_cast<const float*>(x2),
                                                      static_cast<const float*>(dy), p, B, Hp, Wp,
                                                      Ho, Wo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_wgrad_sum<<<(kOut + kSumCols - 1) / kSumCols, kSumCols * kSumRuns, 0, s>>>(
      p, static_cast<float*>(dk), nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
