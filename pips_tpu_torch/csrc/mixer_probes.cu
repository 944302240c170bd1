// The three probe kernels of tools/debug_mixer_kernel.py, which checked that
// Mosaic lowers the primitives of a fused mixer-block kernel:
//   gelu:         o = bf16(0.5 x (1 + erf(x / sqrt 2))), elementwise in f32
//                 (replaces the pallas_call at :63, body k_erf :35);
//   ln_slice:     o[r, :] = bf16((x[r, 0:D] - mu) * rsqrt(var + 1e-5)), the
//                 LayerNorm of the first D lanes of each row of a wider
//                 matrix, statistics in f32 with var = E[x^2] - mu^2, no
//                 affine and no clamp (:66, body k_ln_slice :41);
//   stream_accum: o (M, N) f32 = sum_b x[:, 0:512] @ w1[b], bf16 products
//                 summed in f32 (:69, body k_block_stream :49, whose grid of
//                 12 weight blocks adds each product into one output block).
//
// What bounds them on an H100, at the tool's shapes (x (128, 4096) bf16, w1
// (12, 512, 2048) bf16): gelu moves 2.1 MB (0.63 us at 3.35 TB/s), ln_slice
// 0.26 MB (0.08 us), stream_accum 25.2 MB of w1 (7.5 us) against 3.2 GFLOP
// (3.3 us at 989 TFLOP/s). All three are bound by bytes, and at these sizes
// they take a few microseconds, near the cost of a launch. stream_accum's
// blocks are sized for cluster placement: a cluster of four needs four free
// block slots in one GPC, and unless every cluster fits at once (64 of them
// here; 92 fit at three blocks an SM, 62 at two, 30 at one) a second wave
// or SMs holding twice the work of the others set the time.
//
// Design. gelu (plain): a grid-stride loop over eight
// values a thread (16-byte loads and stores), GELU as chanff_rows.cuh writes
// it, a * Phi(a), within an f32 ulp of the probe's 0.5 a (1 + erf(a / sqrt 2))
// before the one rounding to bf16. ln_slice: one warp per row, two passes over
// the row's D lanes (the second from L1), the input's row stride given.
//
// stream_accum: the TPU's sequential grid over weight blocks becomes one
// GEMM with K = NB * 512 whose A operand, x[:, 0:512], repeats every 512. It
// is bound by w1's bytes, so the design reads w1 from HBM exactly once with
// many tiles in flight on every SM. A block owns a 64-row by 64-column output
// tile and a quarter of x's 512 lanes (128), over every weight block: split-K
// 4; at the tool's shape 32 column tiles x 2 row tiles x 4 = 256 blocks,
// three an SM at most; the four blocks of an output tile form a thread-block
// cluster. One producer thread issues TMA boxes (128-byte swizzled) into a
// 3-stage ring of 128 x 64 w1 tiles (16 KB, one weight block's rows for the
// block's lanes), full/empty mbarriers per stage; with the first stage it also
// loads the block's lanes of x (64 x 128, two boxes), which stay resident.
// The consumer warpgroup runs wgmma m64n64k16 straight from the swizzled
// tiles (x K-major, w1 MN-major), eight a stage, and releases a stage once the
// next one's products are issued and its own have completed. Each block
// writes its 64 x 64 partial sums into shared memory; then each block of the
// cluster sums its quarter of the rows over the four blocks' partials through
// distributed shared memory in rank order and writes them: no atomics, no
// second pass, the same bits every call. The two row tiles read the same w1
// tiles, the second from L2.
//
// Plain C ABI (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "chanff_rows.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- gelu -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) probe_gelu(const bf16* __restrict__ x,
                                                       bf16* __restrict__ o, int n) {
  const int n8 = n / 8;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    uint4 u = reinterpret_cast<const uint4*>(x)[i];
    bf16* v = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(gelu(__bfloat162float(v[j])));
    reinterpret_cast<uint4*>(o)[i] = u;
  }
  for (int i = n8 * 8 + blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    o[i] = __float2bfloat16(gelu(__bfloat162float(x[i])));
}

// ---- ln_slice ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) probe_ln_slice(const bf16* __restrict__ x,
                                                           bf16* __restrict__ o, int R, int D,
                                                           int ldx) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const bf16* src = x + (size_t)row * ldx;
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float v = __bfloat162float(src[c]);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, k);
    s2 += __shfl_xor_sync(0xffffffffu, s2, k);
  }
  const float mu = s / D;
  const float rsig = rsqrtf(s2 / D - mu * mu + kEps);
  for (int c = lane; c < D; c += 32)
    o[(size_t)row * D + c] = __float2bfloat16((__bfloat162float(src[c]) - mu) * rsig);
}

// ---- stream_accum -----------------------------------------------------------

constexpr int kK = 512;               // x's lanes in the product: one weight block's rows
constexpr int kBM = 64;               // output rows a block: one warpgroup's
constexpr int kBN = 64;               // output columns a block: one 128-byte TMA box row
constexpr int kBK = 128;              // x lanes a block owns; w1 rows a stage
constexpr int kSplit = kK / kBK;      // blocks of a cluster, each kBK of x's lanes
constexpr int kRing = 3;              // stages in the ring
constexpr int kConsumers = 4;         // consumer warps (a warpgroup); one more produces
constexpr int kSaThreads = (kConsumers + 1) * 32;
constexpr int kXHalf = kBM * 64 * 2;    // 8,192: x[rows, 64 lanes], one swizzled box
constexpr int kXBytes = kBK / 64 * kXHalf;  // 16,384: the block's lanes of x
constexpr int kWTile = kBK * kBN * 2;   // 16,384: w1[128 rows, 64 columns], swizzled
constexpr int kLdR = kBN + 8;           // f32 row stride of the partial sums
// 1024 bytes to align the tiles, x's lanes, the ring, 2 * kRing mbarriers
constexpr size_t kSaSmem = 1024 + (size_t)kXBytes + (size_t)kRing * kWTile +
                           2 * kRing * 8;  // 66,608: three blocks an SM
static_assert(kK % kBK == 0 && kBK % 64 == 0, "x's lanes shared evenly over a cluster");
static_assert(kWTile % 1024 == 0 && kXHalf % 1024 == 0, "tiles 1024-byte aligned");
static_assert(kBN == 64, "a w1 row of a tile is one 128-byte TMA box row");
static_assert((size_t)kBM * kLdR * 4 <= (size_t)kRing * kWTile, "partial sums over the ring");

// o (M, N) f32 = sum_{b < NB} x[:, 0:kK] @ w[b]. x_map: x[:, 0:kK] as M rows
// (boxes of kBM rows); w_map: w as NB * kK rows of N (boxes of kBK rows).
// Grid (N / kBN * kSplit, ceil(M / kBM)), clusters of kSplit along x.
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kSaThreads, 3)
probe_stream_accum(__grid_constant__ const CUtensorMap x_map,
                   __grid_constant__ const CUtensorMap w_map, float* __restrict__ o, int M,
                   int N, int NB) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ws = xs + kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kRing * kWTile);
  uint64_t* empty = full + kRing;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = (blockIdx.x / kSplit) * kBN, m_base = blockIdx.y * kBM;
  const int rows = min(kBM, M - m_base);
  const int k0 = split * kBK;  // this block's lanes of x; stage i: those rows of w1[i]

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[32];  // a consumer's share of its warpgroup's 64 x 64 accumulator
  if (warp == kConsumers) {
    // producer (one thread): w1's tiles through the ring, and with the first
    // stage the block's lanes of x, which stay resident
    if (lane == 0) {
      for (int i = 0; i < NB; ++i) {
        const int s = i % kRing;
        if (i >= kRing) mbar_wait(&empty[s], ((i / kRing) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kWTile + (i == 0 ? kXBytes : 0));
        for (int h = 0; i == 0 && h < kBK / 64; ++h)
          tma_load_2d(xs + h * kXHalf, &x_map, k0 + h * 64, m_base, &full[s]);
        tma_load_2d(ws + s * kWTile, &w_map, n0, i * kK + k0, &full[s]);
      }
    }
  } else {
    // the consumer warpgroup: wgmma m64n64k16 eight times a stage; a stage is
    // released once the next one's products are issued and its own have
    // completed
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    for (int i = 0; i < NB; ++i) {
      const int s = i % kRing;
      mbar_wait(&full[s], (i / kRing) & 1);
      const unsigned char* wb = ws + s * kWTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)  // A: 32 bytes along a box's rows; B: 16 rows
        wgmma_m64n64k16<0, 1>(acc,
                              gmma_desc(xs + (ks / 4) * kXHalf + (ks % 4) * 32, 16, 1024, 128),
                              gmma_desc(wb + ks * 16 * kBN * 2, 8192, 1024, 128));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kRing]);
    }
    wgmma_wait<0>();
  }

  // every box has landed and been read: the ring holds the partial sums, each
  // warp's 16 rows in the C-fragment order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ws);  // [kBM][kLdR]
  if (warp < kConsumers) {
    const int r = warp * 16 + lane / 4;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<float2*>(red + (r + 8 * hi) * kLdR + nt * 8 + 2 * (lane % 4)) =
            make_float2(acc[4 * nt + 2 * hi], acc[4 * nt + 2 * hi + 1]);
  }

  // block `split` of the cluster: rows split*32 .. +31, summed over the
  // cluster's blocks in rank order
  cluster.sync();
  for (int e = tid; e < (kBM / kSplit) * (kBN / 4); e += kSaThreads) {
    const int r = split * (kBM / kSplit) + e / (kBN / 4), c = (e % (kBN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kSplit; ++k) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, k) + r * kLdR + c);
      v = make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
    }
    if (r < rows) *reinterpret_cast<float4*>(o + (size_t)(m_base + r) * N + n0 + c) = v;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace

extern "C" {

// x and o: n bf16 values each, 16-byte aligned.
int pips_probe_gelu(const void* x, void* o, int n, int device, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int want = (n / 8 + kThreads - 1) / kThreads;
  const int blocks = want < 4 * sms ? (want > 0 ? want : 1) : 4 * sms;
  probe_gelu<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(o), n);
  return (int)cudaGetLastError();
}

// x (R, >= D) bf16 at row stride ldx; o (R, D) bf16 contiguous.
int pips_probe_ln_slice(const void* x, void* o, int R, int D, int ldx, int device,
                        void* stream) {
  if (R <= 0 || D <= 0 || ldx < D) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  probe_ln_slice<<<(R + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(o), R, D, ldx);
  return (int)cudaGetLastError();
}

// x (M, >= 512) bf16 at row stride ldx (a multiple of 8); w (NB, 512, N) bf16
// contiguous, N a multiple of 64; o (M, N) f32 contiguous; all 16-byte aligned.
int pips_probe_stream_accum(const void* x, const void* w, void* o, int M, int N, int NB,
                            int ldx, int device, void* stream) {
  if (M <= 0 || N <= 0 || N % kBN || NB <= 0 || ldx < kK || ldx % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap x_map, w_map;
  err = make_map_2d_bf16(&x_map, x, kK, M, (uint64_t)ldx * 2, kBM);
  if (err != cudaSuccess) return (int)err;
  err = make_map_2d_bf16(&w_map, w, N, (uint64_t)NB * kK, (uint64_t)N * 2, kBK);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(probe_stream_accum, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN * kSplit, (M + kBM - 1) / kBM);
  probe_stream_accum<<<grid, kSaThreads, kSaSmem, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<float*>(o), M, N, NB);
  return (int)cudaGetLastError();
}

}  // extern "C"
