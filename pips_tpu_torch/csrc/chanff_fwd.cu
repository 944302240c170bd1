// Fused MLP-Mixer channel block, forward:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the TPU kernel pips_tpu/kernels/mixer_pallas.py:_chanff_fwd
// (pallas_call of _chanff_fwd_kernel). x is (R, D) rows, R = B*N*S; the PIPs
// delta block runs it 12 times per refinement iteration at D=512, F=2048, the
// Pips2 refiner once a block (6 by default) at D=256, F=1024 (at the
// refiner's 512 x 12, also D=512), in bf16 or (with --dtype float32) in f32.
// D is each kernel's template parameter; the C entry takes 256 and 512.
//
// What bounds it on an H100: two products of 2*R*D*F operations each, 4*R*D*F
// in all, against x and y once, both weights once and the f32 vectors once.
// In bf16 at R=24,576 that is 103 GFLOP (0.104 ms at 989 TFLOP/s) against
// ~54 MB (0.016 ms at 3.35 TB/s): the tensor cores, from a few hundred rows
// up. In f32 the same work takes 1.54 ms at the 67 TFLOP/s of the FMA units.
// A product fed from L2 must reuse each staged weight tile across many rows
// and keep its copies in flight while it computes; R*F exact-erf GELUs (50M
// at R=24,576) add an epilogue of ALU work.
//
// Design. The TPU kernel keeps w1 and w2 resident in VMEM and walks the rows
// once. Hopper blocks hold 227 KB, not the 2 MB bf16 weights, so the forward
// is recast as two tiled products on 128 x 128 output tiles, each staged
// weight tile serving 128 rows, in three launches (the host's plan,
// mixer_cuda.fwd_plan, has their grids):
//   1 chanff_fwd_ln: xa_c = LN(x) * scale + bias in the compute dtype, a warp
//     a row; bound by its bytes;
//   2 chanff_fwd_act: for 128 rows x 128 columns of F, a1 = xa_c @ w1
//     (K = D); the epilogue writes g1_c = gelu(a1 + b1) in the compute
//     dtype;
//   3 chanff_fwd_out: for 128 rows x 128 of the D columns, o = g1_c @ w2
//     (K = F); the epilogue writes y = x + (o + b2) in f32, cast to x's
//     dtype, x read in rounds of loads issued before any is used. Where its
//     D / 128 * ceil(R / 128) tiles would leave most of the card idle, K is split
//     over a thread-block cluster of `split` blocks, which add their partial
//     tiles in rank order through distributed shared memory: every output is
//     deterministic, with no atomics.
// g1_c goes to memory between the two products. The reference rounds it to
// the compute dtype there too, so nothing is lost, and it is 2*R*F elements
// of traffic (0.2 GB in bf16 at R=24,576, ~0.06 ms); one launch that kept it
// on chip would hold a (rows, D) f32 accumulator, at most 64 rows a block,
// and stream both weights from L2 for every 64 rows.
// The mainloops and the activation epilogue are chanff_tiles.cuh's, shared
// with chanff_bwd.cu: bf16 (namespace tc) on wgmma m64n128k16 behind a TMA
// ring (one producer warp, two consumer warpgroups of 64 rows), the
// accumulators staged to the freed ring as an f32 tile before the epilogue;
// f32 (namespace simt) a register-tiled SGEMM on cp.async that stays on the
// FMA units (TF32 would drop the f32 products the reference keeps).
//
// Numerics follow chan_ff_reference: LN statistics in f32 with
// var = E[x^2] - mu^2 clamped at 0, eps 1e-5; both products take the compute
// dtype and accumulate in f32; exact-erf GELU in f32, CUDA's erff standing in
// for the rational erf the TPU kernel uses (XLA's ErfImpl32, a few f32 ulps
// apart), g1 cast to the compute dtype; b2 and the residual in f32.
//
// Plain C ABI (loaded with ctypes): pips_chanff_fwd returns cudaGetLastError()
// after the last launch; 0 means launched.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chanff_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSplit = 4;  // K splits of the out product at most: the blocks of a cluster
constexpr int kXRound = 8;    // x loads a thread issues before it uses the first

// ------------------------------------------------------------ 1: LN rows
// xa[row] = LN(x[row]) * scale + bias in T; grid ceil(R / kLnRows)
template <int D, typename T>
__global__ void __launch_bounds__(32 * kLnRows)
chanff_fwd_ln(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ xa, int R) {
  ln_row_pass<D>(x, scale, bias, xa, nullptr, R);
}

// ------------------------------------------ 3: the out product's epilogue
// The out product's tile (rows row0 .., columns n0 .. of D), staged as f32
// [128][kLdt] by each of the `split` blocks of a cluster that cut K between
// them (split 1: one block, no cluster): block z takes its share of the rows,
// sums their partial tiles over the cluster in rank order and writes
// y = x + (o + b2) in T. Every thread of the block calls it.
template <int D, typename T>
__device__ __forceinline__ void out_epilogue(float* tile, const T* __restrict__ x,
                                             const float* __restrict__ b2, T* __restrict__ y,
                                             int n0, int row0, int R, int split) {
  constexpr int kGroups = kTileCols / 4;  // 4-column groups of a row
  cg::cluster_group cluster = cg::this_cluster();
  const float* part[kMaxSplit];  // indexed by constants only: kept in registers
  if (split > 1) {
    cluster.sync();  // every block's partial tile is staged
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k)
      part[k] = cluster.map_shared_rank(tile, k < split ? k : 0);
  } else {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxSplit; ++k) part[k] = tile;
  }
  const int r0 = kTileRows * (int)blockIdx.z / split;
  const int n = (kTileRows * ((int)blockIdx.z + 1) / split - r0) * kGroups;
  for (int q0 = threadIdx.x; q0 < n; q0 += kXRound * blockDim.x) {
    float4 xv[kXRound];
#pragma unroll
    for (int u = 0; u < kXRound; ++u) {
      const int q = q0 + u * blockDim.x, row = row0 + r0 + q / kGroups;
      xv[u] = q < n && row < R ? load4(x + (size_t)row * D + n0 + 4 * (q % kGroups))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kXRound; ++u) {
      const int q = q0 + u * blockDim.x, r = r0 + q / kGroups, c = 4 * (q % kGroups);
      if (q >= n || row0 + r >= R) continue;
      float4 o = *reinterpret_cast<const float4*>(part[0] + r * kLdt + c);
#pragma unroll
      for (int k = 1; k < kMaxSplit; ++k) {
        if (k >= split) break;
        const float4 p = *reinterpret_cast<const float4*>(part[k] + r * kLdt + c);
        o = make_float4(o.x + p.x, o.y + p.y, o.z + p.z, o.w + p.w);
      }
      const float4 b = *reinterpret_cast<const float4*>(b2 + n0 + c);
      store4(y + (size_t)(row0 + r) * D + n0 + c,
             make_float4(xv[u].x + (o.x + b.x), xv[u].y + (o.y + b.y), xv[u].z + (o.z + b.z),
                         xv[u].w + (o.w + b.w)));
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its tile
}

// ======================================================= bf16: wgmma, TMA ring
namespace tc {
// Both products run two blocks an SM, each with a ring of three stages: one
// block's epilogue overlaps the other's products (at R=24,576 that took 21%
// off the call against one block an SM with six stages).
constexpr int kBlocksPerSM = 2;

// ---- 2: the activation product
constexpr int kActStages = 3;
using ActRing = Ring<kActStages>;
static_assert(kTileF32 <= kActStages * kStageBytes, "a1 staged over the ring");

// grid (ceil(F / 128), ceil(R / 128)). xa_map: (R, D) in boxes of 128
// rows; w1_map: (D, F) in boxes of 64.
template <int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chanff_fwd_act(const __grid_constant__ CUtensorMap xa_map,
               const __grid_constant__ CUtensorMap w1_map, const float* __restrict__ b1,
               bf16* __restrict__ g1, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ActRing ring(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  constexpr int kSteps = D / BK;
  if (tid == 0) ring.init();
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      tma_prefetch_map(&xa_map);
      tma_prefetch_map(&w1_map);
      for (int i = 0; i < kSteps; ++i) {
        unsigned char* st = ring.acquire(i);
        load_k(st, &xa_map, i * BK, row0, ring.bar(i));
        load_mn(st + kStageA, &w1_map, f0, i * BK, ring.bar(i));
      }
    }
    return;
  }

  const int wg = warp / 4;
  float* a1s = reinterpret_cast<float*>(ring.tiles);
  {
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    consume<0, 1>(ring, acc, 0, kSteps, wg);
    named_sync(1, kConsumers);  // every warpgroup's products are done: the ring is free
    stage_acc(a1s, acc, wg);
  }
  named_sync(1, kConsumers);
  act_epilogue<bf16>(Staged{a1s}, NoGrad{}, b1, g1, nullptr, nullptr, nullptr, f0, row0, R, F);
}

// ---- 3: the out product
constexpr int kOutStages = 3;
using OutRing = Ring<kOutStages>;
static_assert(kTileF32 <= kOutStages * kStageBytes, "o staged over the ring");

// grid (D / 128, ceil(R / 128), split), clusters of `split` along z; block
// z takes the z-th of `split` runs of F's k-steps. g1_map: (R, F) in boxes
// of 128 rows; w2_map: (F, D) in boxes of 64.
template <int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
chanff_fwd_out(const __grid_constant__ CUtensorMap g1_map,
               const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
               const float* __restrict__ b2, bf16* __restrict__ y, int R, int F, int split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  OutRing ring(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  int i0, i1;
  split_range(F / BK, split, blockIdx.z, i0, i1);
  if (tid == 0) ring.init();
  __syncthreads();

  float* os = reinterpret_cast<float*>(ring.tiles);
  if (warp == kProducerWarp) {
    if (lane == 0) {
      tma_prefetch_map(&g1_map);
      tma_prefetch_map(&w2_map);
      for (int i = i0; i < i1; ++i) {
        unsigned char* st = ring.acquire(i - i0);
        load_k(st, &g1_map, i * BK, row0, ring.bar(i - i0));
        load_mn(st + kStageA, &w2_map, n0, i * BK, ring.bar(i - i0));
      }
    }
  } else {
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    consume<0, 1>(ring, acc, 0, i1 - i0, wg);
    named_sync(1, kConsumers);  // every warpgroup's products are done: the ring is free
    stage_acc(os, acc, wg);
  }
  out_epilogue<D, bf16>(os, x, b2, y, n0, row0, R, split);
}

template <int D>
cudaError_t launch(const bf16* x, const float* scale, const float* bias, const bf16* w1,
                   const float* b1, const bf16* w2, const float* b2, bf16* y, bf16* xa, bf16* g1,
                   int R, int F, int split, cudaStream_t s) {
  const int nblk = (R + kTileRows - 1) / kTileRows;
  chanff_fwd_ln<D, bf16><<<(R + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(x, scale, bias, xa,
                                                                              R);
  cudaError_t err = cudaGetLastError();
  CUtensorMap xa_map, w1_map, g1_map, w2_map;
  if (err == cudaSuccess) err = make_map_2d_bf16(&xa_map, xa, D, R, D * 2, kTileRows);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w1_map, w1, F, D, (uint64_t)F * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&g1_map, g1, F, R, (uint64_t)F * 2, kTileRows);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w2_map, w2, D, F, D * 2, 64);
  if (err == cudaSuccess) err = set_smem(chanff_fwd_act<D>, ActRing::kSmem);
  if (err == cudaSuccess) err = set_smem(chanff_fwd_out<D>, OutRing::kSmem);
  if (err != cudaSuccess) return err;
  chanff_fwd_act<D><<<dim3((F + kTileCols - 1) / kTileCols, nblk), kThreads, ActRing::kSmem, s>>>(
      xa_map, w1_map, b1, g1, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_clusters(chanff_fwd_out<D>, dim3(D / kTileCols, nblk, split), dim3(1, 1, split),
                         kThreads, OutRing::kSmem, s, g1_map, w2_map, x, b2, y, R, F, split);
}
}  // namespace tc

// ================================================ f32: register-tiled SGEMMs
namespace simt {
// an epilogue thread's 8 x 8 values (rows own(ty, i), columns own(tx, j))
// into an f32 [128][kLdt] tile
__device__ __forceinline__ void stage_regs(float* tile, const float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store4(tile + own(ty, i) * kLdt + 64 * h + 4 * tx,
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
}

// ---- 2: the activation product; grid (ceil(F / 128), ceil(R / 128)). One
// block an SM: at two, ptxas spilled (128 registers) and the call ran 1.5%
// slower at R=24,576.
constexpr size_t kActSmem = (size_t)kStages * 2 * kOp * sizeof(float);

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_fwd_act_f32(const float* __restrict__ xa, const float* __restrict__ w1,
                   const float* __restrict__ b1, float* __restrict__ g1, int R, int F) {
  extern __shared__ __align__(16) float sm[];  // [kStages][xa, w1][kOp]
  const int f0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  const Operand xa_op{xa, D, R, D}, w1_op{w1, F, F, D};
  float acc[8][8];
  zero(acc);
  pipeline(
      0, D / BK,
      [&](int slot, int k0) {
        float* s = sm + slot * 2 * kOp;
        stage_a<true>(s, xa_op, row0, k0);
        stage_b<false>(s + kOp, w1_op, f0, k0);
      },
      [&](int slot) {
        const float* s = sm + slot * 2 * kOp;
        fma_tiles<true>(acc, s, s + kOp);
      });
  act_epilogue<float>(Regs{acc}, NoGrad{}, b1, g1, nullptr, nullptr, nullptr, f0, row0, R, F);
}

// ---- 3: the out product; grid (D / 128, ceil(R / 128), split), as tc's
constexpr size_t kOutSmem = (size_t)kTileRows * kLdt * sizeof(float);  // the staged tile
static_assert(kOutSmem >= (size_t)kStages * 2 * kOp * sizeof(float), "the stages fit under it");

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
chanff_fwd_out_f32(const float* __restrict__ g1, const float* __restrict__ w2,
                   const float* __restrict__ x, const float* __restrict__ b2,
                   float* __restrict__ y, int R, int F, int split) {
  extern __shared__ __align__(16) float sm[];  // [kStages][g1, w2][kOp], then the tile
  const int n0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  const Operand g1_op{g1, F, R, F}, w2_op{w2, D, D, F};
  int i0, i1;
  split_range(F / BK, split, blockIdx.z, i0, i1);
  float acc[8][8];
  zero(acc);
  pipeline(
      i0, i1,
      [&](int slot, int k0) {
        float* s = sm + slot * 2 * kOp;
        stage_a<true>(s, g1_op, row0, k0);
        stage_b<false>(s + kOp, w2_op, n0, k0);
      },
      [&](int slot) {
        const float* s = sm + slot * 2 * kOp;
        fma_tiles<true>(acc, s, s + kOp);
      });
  stage_regs(sm, acc);  // the pipeline ended past every thread's products: the stages are free
  out_epilogue<D, float>(sm, x, b2, y, n0, row0, R, split);
}

template <int D>
cudaError_t launch(const float* x, const float* scale, const float* bias, const float* w1,
                   const float* b1, const float* w2, const float* b2, float* y, float* xa,
                   float* g1, int R, int F, int split, cudaStream_t s) {
  const int nblk = (R + kTileRows - 1) / kTileRows;
  cudaError_t err = set_smem(chanff_fwd_act_f32<D>, kActSmem);
  if (err == cudaSuccess) err = set_smem(chanff_fwd_out_f32<D>, kOutSmem);
  if (err != cudaSuccess) return err;
  chanff_fwd_ln<D, float><<<(R + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(x, scale, bias,
                                                                                xa, R);
  chanff_fwd_act_f32<D><<<dim3((F + kTileCols - 1) / kTileCols, nblk), kThreads, kActSmem, s>>>(
      xa, w1, b1, g1, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_clusters(chanff_fwd_out_f32<D>, dim3(D / kTileCols, nblk, split),
                         dim3(1, 1, split), kThreads, kOutSmem, s, g1, w2, x, b2, y, R, F, split);
}
}  // namespace simt

}  // namespace

extern "C" {

// Shapes the kernel takes: D == 256 or 512; F a positive multiple of 64; R >= 1;
// tile_rows == 128, the rows of the products' tiles; 1 <= split <= 4 and
// split <= F / 64, the out product's K splits (the blocks of a cluster).
// dtype_code 0 = float32, 1 = bfloat16 (x, w1, w2, y and the scratch the
// caller allocates: xa (R, D) and g1 (R, F)); ln_scale, ln_bias, b1, b2 are
// float32. All pointers 16-byte aligned and contiguous.
int pips_chanff_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* y, void* xa, void* g1,
                    int R, int D, int F, int tile_rows, int split, int dtype_code, int device,
                    void* stream) {
  if ((D != 256 && D != 512) || F <= 0 || F % 64 != 0 || R <= 0 || tile_rows != kTileRows ||
      split < 1 || split > kMaxSplit || split > F / 64 || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(ln_scale);
  const float* bi = static_cast<const float*>(ln_bias);
  const float* bb1 = static_cast<const float*>(b1);
  const float* bb2 = static_cast<const float*>(b2);
  if (dtype_code == 1) {
    const auto launch = D == 256 ? &tc::launch<256> : &tc::launch<512>;
    return (int)launch(static_cast<const bf16*>(x), sc, bi, static_cast<const bf16*>(w1), bb1,
                       static_cast<const bf16*>(w2), bb2, static_cast<bf16*>(y),
                       static_cast<bf16*>(xa), static_cast<bf16*>(g1), R, F, split, s);
  }
  const auto launch = D == 256 ? &simt::launch<256> : &simt::launch<512>;
  return (int)launch(static_cast<const float*>(x), sc, bi, static_cast<const float*>(w1), bb1,
                     static_cast<const float*>(w2), bb2, static_cast<float*>(y),
                     static_cast<float*>(xa), static_cast<float*>(g1), R, F, split, s);
}

}  // extern "C"
