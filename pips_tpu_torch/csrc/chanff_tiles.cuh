// The tiled products of the channel block's kernels (chanff_fwd.cu,
// chanff_bwd.cu) and what they share: the LN row pass; the tiles (128 rows by
// 128 columns, a split's k-steps; the channel width D, a multiple of 128, is
// each kernel's template parameter); the activation epilogue, g1 = gelu(a1 + b1)
// and in the backward da1 with its column sums; and one mainloop for each
// dtype:
//   tc (bf16): wgmma m64n128k16 from shared memory with f32 accumulators, its
//   operands brought by TMA (128-byte swizzled boxes, rows past R read as
//   zero) through an mbarrier ring: one producer warp keeps the ring full
//   while two consumer warpgroups each take 64 rows of the tile. K-major
//   tiles are one box of 128 rows, MN-major tiles two boxes of 64 x 64, read
//   through wgmma's transposed-operand modes. stage_acc moves a warpgroup's
//   accumulators to the freed ring as an f32 tile before a long epilogue.
//   simt (f32): a register-tiled SGEMM, 128 x 128 block tiles of 256 threads,
//   8 x 8 outputs a thread, K in steps of 16 through three cp.async stages;
//   it stays on the FMA units (mma.sync with f32 operands is TF32, which
//   would drop the f32 products the reference keeps).
// Each source includes this header once, in its own translation unit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "async_copy.cuh"
#include "chanff_rows.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 128;            // rows of a row tile: the partials' blocks
constexpr int kTileCols = 128;            // columns of every output tile
constexpr int kLnRows = 8;                // rows of an LN block, a warp each
constexpr int kEpi = 256;                 // the threads of a tile's epilogue
constexpr int kLdt = kTileCols + 4;       // f32 row stride of a tile staged in shared memory

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// kernel over `grid` in thread-block clusters of `cluster` blocks (no cluster
// attribute for 1 x 1 x 1): the forward's out product splits K over a
// cluster along z, the backward's dxa products a row tile's D / 128 blocks
// along x; returns the launch's error
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, dim3 cluster, int threads, size_t smem,
                            cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = cluster.x * cluster.y * cluster.z > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---- the LN row pass: a warp a row of D, blocks of kLnRows rows
// xa[row] = LN(x[row]) * scale + bias in T; with stats, stats[row] = mu and
// stats[R + row] = rsig
template <int D, typename T>
__device__ __forceinline__ void ln_row_pass(const T* __restrict__ x,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias, T* __restrict__ xa,
                                            float* __restrict__ stats, int R) {
  static_assert(D % 32 == 0, "a lane takes D / 32 columns");
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const T* src = x + (size_t)row * D;
  float v[D / 32];
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    v[i] = to_f32(src[lane + 32 * i]);
    s += v[i];
    s2 += v[i] * v[i];
  }
  float mu, rsig;
  warp_ln_stats<D>(s, s2, mu, rsig);
  if (stats != nullptr && lane == 0) {
    stats[row] = mu;
    stats[R + row] = rsig;
  }
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = lane + 32 * i;
    xa[(size_t)row * D + c] = from_f32<T>((v[i] - mu) * rsig * scale[c] + bias[c]);
  }
}

// the k-steps [i0, i1) of split s of n steps cut into `split` runs
__device__ __forceinline__ void split_range(int n, int split, int s, int& i0, int& i1) {
  const int per = (n + split - 1) / split;
  i0 = min(n, s * per);
  i1 = min(n, i0 + per);
}

// ================================ the epilogues, shared by both dtypes
// Epilogue thread t < 256, (ty, tx) = (t / 16, t % 16), owns rows 4 ty + i
// and 64 + 4 ty + i, and columns 4 tx + j and 64 + 4 tx + j (i, j < 4) of a
// 128 x 128 output tile: index i of its 8 is local row own(ty, i). acc4(i, h)
// gives its four values at row own(ty, i), columns own(tx, 4 h ..): from
// registers (the f32 SGEMM's own layout) or from the tile staged in shared
// memory (bf16, from wgmma's fragments). Rows never share a writer: every
// sum is taken in a fixed order.
__device__ __forceinline__ int own(int t16, int i) { return (i < 4 ? 0 : 60) + 4 * t16 + i; }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                                            bits(__floats2bfloat162_rn(v.z, v.w)));
}

// the forward's activation epilogue: no dg1, so no da1 and no column sums
struct NoGrad {
  __device__ float4 operator()(int, int) const { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

// the activation products' epilogue on a tile of rows row0 .., columns f0 ..
// of F: g1 = gelu(a), da1 = dg1 * gelu'(a) with a = a1 + b1 in f32, stored in
// T; the tile's column sums of da1 into part_f (red: 8 x 128 floats of
// shared memory). With dg a NoGrad (the forward), g1 alone: da1, part_f and
// red are not touched.
template <typename T, class A1, class DG>
__device__ __forceinline__ void act_epilogue(A1 a1, DG dg, const float* __restrict__ b1,
                                             T* __restrict__ g1, T* __restrict__ da1,
                                             float* __restrict__ part_f, float* red, int f0,
                                             int row0, int R, int F) {
  constexpr bool kGrad = !std::is_same<DG, NoGrad>::value;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16, warp = t / 32;
  float bb[8], cs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = f0 + own(tx, j);
    bb[j] = c < F ? b1[c] : 0.0f;
    cs[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + own(ty, i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 av = a1(i, h), dv = dg(i, h);
      const float as[4] = {av.x, av.y, av.z, av.w}, ds[4] = {dv.x, dv.y, dv.z, dv.w};
      float g[4], d[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float a = as[jj] + bb[4 * h + jj];
        const float cdf = gelu_cdf(a);
        g[jj] = a * cdf;
        if constexpr (kGrad) {
          d[jj] = ds[jj] * (cdf + a * gelu_pdf(a));
          if (row < R) cs[4 * h + jj] += d[jj];
        }
      }
      const int c = f0 + 64 * h + 4 * tx;
      if (row < R && c < F) {
        const size_t o = (size_t)row * F + c;
        store4(g1 + o, make_float4(g[0], g[1], g[2], g[3]));
        if constexpr (kGrad) store4(da1 + o, make_float4(d[0], d[1], d[2], d[3]));
      }
    }
  }
  if constexpr (!kGrad) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if (t % 32 < 16) red[warp * kTileCols + own(tx, j)] = cs[j];
  }
  named_sync(1, kEpi);
  if (t < kTileCols && f0 + t < F) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kEpi / 32; ++w) s += red[w * kTileCols + t];
    part_f[(size_t)blockIdx.y * F + f0 + t] = s;
  }
}

// ======================================================= bf16: wgmma, TMA ring
namespace tc {
constexpr int BK = 64;                              // K of a stage: one 128-byte swizzled row
constexpr int kStageA = kTileRows * BK * 2;         // 16,384
constexpr int kStageB = kTileCols * BK * 2;         // 16,384
constexpr int kStageBytes = kStageA + kStageB;      // 32,768
constexpr int kConsumers = kEpi;                    // two warpgroups, 64 rows of a tile each
constexpr int kThreads = kConsumers + 32;           // and one producer warp
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kBox = 64 * 64 * 2;                   // 8,192: a 64 x 64 box, 128-byte swizzled
constexpr int kTileF32 = kTileRows * kLdt * 4;      // 67,584: a staged f32 tile
static_assert(kStageA == 2 * kBox && kStageB == 2 * kBox, "a tile is two 64-row boxes");

// A ring of kStages stages of one A and one B tile, full and empty mbarriers
// each; step i of a block's k-loop goes through stage i % kStages
template <int kStages>
struct Ring {
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 2 * kStages * 8;
  unsigned char* tiles;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Ring(unsigned char* raw) {
    tiles = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                             ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
    empty = full + kStages;
  }
  // one thread, then a block barrier
  __device__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  // producer: step i's stage once its last products are done, armed for its bytes
  __device__ unsigned char* acquire(int i) {
    const int s = i % kStages;
    if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
    mbar_arrive_expect_tx(&full[s], kStageBytes);
    return tiles + s * kStageBytes;
  }
  __device__ uint64_t* bar(int i) { return &full[i % kStages]; }
  // consumer: step i's stage once its tiles have landed
  __device__ const unsigned char* wait(int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    return tiles + (i % kStages) * kStageBytes;
  }
  __device__ void release(int i) {
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[i % kStages]);
  }
};

// a K-major tile: 128 rows from r0, K from k0 (64), one box of a map in boxes of 128 rows
__device__ __forceinline__ void load_k(unsigned char* dst, const CUtensorMap* map, int k0, int r0,
                                       uint64_t* bar) {
  tma_load_2d(dst, map, k0, r0, bar);
}
// an MN-major tile: K rows from k0 (64), 128 columns from n0, two boxes of 64 x 64
__device__ __forceinline__ void load_mn(unsigned char* dst, const CUtensorMap* map, int n0, int k0,
                                        uint64_t* bar) {
  tma_load_2d(dst, map, n0, k0, bar);
  tma_load_2d(dst + kBox, map, n0 + 64, k0, bar);
}

// acc (warpgroup wg's 64 rows x 128) += one stage's A (128 x 64) B (64 x 128).
// TA, TB: 0 K-major, 1 MN-major. A K-major tile's rows 64 wg .. are 8192
// bytes in, as is an MN-major tile's second box; a k16 step is 32 bytes
// along a K-major row, 16 rows (2048 bytes) down an MN-major box; 8-row
// groups are 1024 bytes apart, an MN-major operand's 64-column groups 8192
template <int TA, int TB>
__device__ __forceinline__ void stage_mma(float* acc, const unsigned char* st, int wg) {
  const unsigned char* a = st + wg * kBox;
  const unsigned char* b = st + kStageA;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n128k16<TA, TB>(
        acc, TA ? gmma_desc(a + kk * 2048, kBox, 1024, 128) : gmma_desc(a + kk * 32, 16, 1024, 128),
        TB ? gmma_desc(b + kk * 2048, kBox, 1024, 128) : gmma_desc(b + kk * 32, 16, 1024, 128));
}

// a consumer warpgroup: acc += the products of steps [i0, i1); each stage is
// released once the next one's products are issued and its own are done
template <int TA, int TB, int kStages>
__device__ __forceinline__ void consume(Ring<kStages>& ring, float* acc, int i0, int i1, int wg) {
  for (int i = i0; i < i1; ++i) {
    const unsigned char* st = ring.wait(i);
    wgmma_fence();
    stage_mma<TA, TB>(acc, st, wg);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > i0) ring.release(i - 1);
  }
  wgmma_wait<0>();
  if (i1 > i0) ring.release(i1 - 1);
}

// a warpgroup's accumulator (64 x 128 in wgmma's fragments: value 4 n + 2 hi
// + e at row 16 warp + lane / 4 + 8 hi, column 8 n + 2 (lane % 4) + e) into
// rows 64 wg .. of an f32 [128][kLdt] tile, which frees the registers for a
// long epilogue
__device__ __forceinline__ void stage_acc(float* tile, const float* acc, int wg) {
  const int wl = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  float* r = tile + (64 * wg + 16 * wl + lane / 4) * kLdt + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<float2*>(r + 8 * hi * kLdt + 8 * n) =
          make_float2(acc[4 * n + 2 * hi], acc[4 * n + 2 * hi + 1]);
}

// an epilogue thread's four values (row own(ty, i), columns own(tx, 4 h ..)) of a staged tile
struct Staged {
  const float* tile;
  __device__ float4 operator()(int i, int h) const {
    const int t = threadIdx.x;
    return *reinterpret_cast<const float4*>(tile + own(t / 16, i) * kLdt + 64 * h + 4 * (t % 16));
  }
};
}  // namespace tc

// ================================================ f32: register-tiled SGEMMs
namespace simt {
constexpr int BK = 16;                  // K of a stage
constexpr int kStages = 3;              // cp.async stages in flight
constexpr int kThreads = kEpi;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = kTileRows + 4;      // f32 row stride of an operand staged [k][m]
constexpr int LDK = BK + 4;             // f32 row stride of an operand staged [m][k]
constexpr int kOp = kTileRows * LDK;    // floats of one staged operand tile, either way
static_assert(kTileRows == kTileCols && kTileRows == 128 && kOp >= BK * LDS, "the thread map");

// An operand of a product, element (k, m) at p[k * ld + m] when its rows run
// along M or N, at p[m * ld + k] when they run along K; m at or past m_end
// and k at or past k_end read as zero.
struct Operand {
  const float* p;
  int ld, m_end, k_end;
};

// A's (BK, 128) tile at (k0, m0) into dst by 16-byte cp.async, as the
// operand lies: [m][k] when its rows run along K (kK), else [k][m]
template <bool kK>
__device__ __forceinline__ void stage_a(float* dst, const Operand& op, int m0, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < BK * kTileRows / 4 / kThreads; ++j) {
    const int q = t + j * kThreads;
    const int m = kK ? q / (BK / 4) : (q % (kTileRows / 4)) * 4;
    const int k = kK ? (q % (BK / 4)) * 4 : q / (kTileRows / 4);
    const bool ok = m0 + m < op.m_end && k0 + k < op.k_end;
    const size_t src = kK ? (size_t)(m0 + m) * op.ld + k0 + k : (size_t)(k0 + k) * op.ld + m0 + m;
    cp_async_16z(dst + (kK ? m * LDK + k : k * LDS + m), ok ? op.p + src : op.p, ok);
  }
}

// B's (BK, 128) tile at (k0, n0) into dst as [k][n]: 16 bytes a copy where
// its rows run along N, 4 bytes (transposing) where they run along K (kK)
template <bool kK>
__device__ __forceinline__ void stage_b(float* dst, const Operand& op, int n0, int k0) {
  const int t = threadIdx.x;
  if (kK) {
#pragma unroll
    for (int j = 0; j < BK * kTileCols / kThreads; ++j) {
      const int e = t + j * kThreads, k = e % BK, n = e / BK;
      const bool ok = n0 + n < op.m_end && k0 + k < op.k_end;
      cp_async_4z(dst + k * LDS + n, ok ? op.p + (size_t)(n0 + n) * op.ld + k0 + k : op.p, ok);
    }
  } else {
    stage_a<false>(dst, op, n0, k0);
  }
}

// acc += a staged A tile times a staged B tile. An [m][k] A is read four k at
// a time (a float4 along each of the thread's rows), a [k][m] one a k at a time
template <bool kKA>
__device__ __forceinline__ void fma_tiles(float (&acc)[8][8], const float* a, const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 4) {
    float a4[8][4];
    if (kKA)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(a + own(ty, i) * LDK + k0);
        a4[i][0] = v.x, a4[i][1] = v.y, a4[i][2] = v.z, a4[i][3] = v.w;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float av[8];
      if (kKA) {
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = a4[i][kk];
      } else {
        const float4 a0 = *reinterpret_cast<const float4*>(a + (k0 + kk) * LDS + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(a + (k0 + kk) * LDS + 64 + 4 * ty);
        av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
        av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(b + (k0 + kk) * LDS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b + (k0 + kk) * LDS + 64 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The mainloop: k-steps [i0, i1) of BK, kStages in flight. stage_fn(slot,
// k0) issues a step's copies into slot, compute_fn(slot) its products. Ends
// with every copy landed and every thread past its last products.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int i0, int i1, Stage stage_fn, Compute compute_fn) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (i0 + s < i1) stage_fn(s, (i0 + s) * BK);
    cp_async_commit();
  }
  for (int i = i0; i < i1; ++i) {
    cp_async_wait<kStages - 2>();  // step i's copies have landed
    __syncthreads();               // and every thread is past step i - 1's products
    const int next = i + kStages - 1;
    if (next < i1) stage_fn((next - i0) % kStages, next * BK);
    cp_async_commit();
    compute_fn((i - i0) % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// an epilogue thread's four values (row own(ty, i), columns own(tx, 4 h ..)) in registers
struct Regs {
  const float (&acc)[8][8];
  __device__ float4 operator()(int i, int h) const {
    return make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
};
}  // namespace simt

}  // namespace
