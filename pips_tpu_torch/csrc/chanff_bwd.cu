// Fused MLP-Mixer channel block, backward:  y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the TPU kernel pips_tpu/kernels/mixer_pallas.py:_chanff_bwd
// (pallas_call of _chanff_bwd_kernel). Given x and dy (R, D) in the compute
// dtype, it recomputes the forward from x and returns dx in x's dtype and f32
// grads of the LN scale and bias, w1, b1, w2 and b2. Training runs it 12 times
// per refinement iteration at D=512, F=2048 (Pips2: once a refiner block at
// D=256, F=1024, or D=512 at the refiner's 512 x 12), in bf16 or (with
// --dtype float32) in f32. D is each kernel's template parameter; the C
// entry takes 256 and 512.
//
// What bounds it on an H100: five products of 2*R*D*F operations each (a1
// recomputed, dg1, dxa, dw1, dw2), 10*R*D*F in all, against x, dy and dx once,
// both weights once and the f32 weight grads once. In bf16 at R=24,576 that
// is 258 GFLOP (0.26 ms at 989 TFLOP/s) against ~100 MB: the tensor cores,
// from a few hundred rows up. In f32 the same work takes 3.85 ms at the 67
// TFLOP/s of the FMA units. A product fed from L2 must reuse each staged
// operand tile across many rows, and keep its copies in flight while it
// computes; R*F exact-erf GELUs and their derivatives (50M at R=24,576) add
// an epilogue of ALU work that no product hides within its own tile.
//
// Design. The TPU kernel keeps w1 and w2 resident in VMEM and walks the rows
// once. Hopper blocks hold 227 KB, not the 2 MB weights, so the backward is
// recast as four tiled products on 128 x 128 output tiles, each staged weight
// tile serving 128 rows, in five launches (the host's plan,
// mixer_cuda.bwd_plan, has their grids):
//   1 chanff_bwd_ln: xa_c = LN(x) * scale + bias in the compute dtype and the
//     f32 row statistics (mu, rsig), a warp a row; bound by its bytes;
//   2 chanff_bwd_act: for 128 rows x 128 columns of F, a1 = xa_c @ w1 and
//     dg1 = dy @ w2^T (K = D); the epilogue forms g1 = gelu(a1 + b1) and
//     da1 = dg1 * gelu'(a1 + b1) in f32, writes g1_c and da1_c (the compute
//     dtype) and the tile's column sums of da1 (the db1 partials). Bound by
//     the epilogue's ALU work more than by the products;
//   3 chanff_bwd_dxa: dxa = da1_c @ w1^T (K = F), 128 rows x 128 of the D
//     columns a block, the D / 128 blocks of a row tile one thread-block
//     cluster (four at D=512, two at 256); the epilogue is the LN backward,
//     whose row means over all D columns the cluster sums in rank order
//     through distributed shared memory
//     (a whole row never has to fit one block, nor dxa go to memory); it
//     reads the tile's x and dy from shared memory, all copied by one round
//     of cp.async as the products end (loads row by row left it waiting on
//     memory), and writes dx and the tile's column sums of dxa * xn, dxa, dy;
//   4 chanff_bwd_wgrad: dw1 = xa_c^T @ da1_c and dw2 = g1_c^T @ dy, K = R,
//     both products' tiles in one grid (128 at D=512, F=2048; 32 at D=256,
//     F=1024); K is split only where those tiles leave blocks the card holds
//     at once idle (f32 at D=512, two blocks an SM; both dtypes at D=256),
//     the splits written to scratch;
//   5 chanff_bwd_colsum: the partials summed over the row tiles in order, and
//     the K splits in order: every grad is deterministic, no atomics.
// The mainloops, the tiles and the activation epilogue are chanff_tiles.cuh's,
// shared with chanff_fwd.cu.
// bf16 (namespace tc): every product is wgmma m64n128k16 from shared memory
// with f32 accumulators, its operands brought by TMA (128-byte swizzled
// boxes, rows past R read as zero) through an mbarrier ring: one producer
// warp keeps the ring full while two consumer warpgroups each take 64 rows
// of the tile. Operands whose rows run along K (xa_c, dy, da1_c, w2 in
// dg1, w1 in dxa) are K-major tiles; those whose rows run along M or N (w1
// in a1, and all four weight-grad operands) are read MN-major through
// wgmma's transposed-operand modes, so no transposed copy is ever written.
// Before an epilogue the accumulators go to the freed ring as an f32 tile,
// which frees the registers (a1 and dg1 hold 128 of a thread's 168) for
// many GELUs in flight at once.
// f32 (namespace simt) stays on the FMA units (mma.sync with f32 operands is
// TF32, which would drop the f32 products the reference keeps, as in
// chanff_fwd.cu): one register-tiled SGEMM mainloop for all products, 128 x
// 128 block tiles of 256 threads, 8 x 8 outputs a thread, K in steps of 16
// through three cp.async stages. A is staged as it lies, [m][k] or [k][m],
// by 16-byte copies; B as [k][n], by 16-byte copies where its rows run along
// N and by 4-byte transposing ones where they run along K (w2 in dg1, w1 in
// dxa). Both dtypes share the two epilogues (act_epilogue, dxa_epilogue).
//
// Numerics follow chan_ff_bwd_reference (the JAX kernel's math): LN in f32
// with var = E[x^2] - mu^2 clamped at 0, eps 1e-5; the five products take the
// compute dtype and accumulate in f32; db1, db2 and the LN grads are summed in
// f32 from unrounded values; gelu'(a) = Phi(a) + a*phi(a) with CUDA's erff for
// XLA's rational erf (a few f32 ulps apart).
//
// Plain C ABI (loaded with ctypes): pips_chanff_bwd returns cudaGetLastError()
// after the last launch; 0 means launched. pips_chanff_bwd_finish runs the
// weight-grad products and the column sums alone on bf16 scratch that another
// kernel wrote (chanff_chunk.cu's, D=512, whose partials come in 64-row tiles).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chanff_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSplit = 16;        // K splits of the weight-grad products at most
constexpr int kLdx = kTileCols + 8;  // row stride (elements) of a staged x or dy tile
constexpr int kFinishD = 512;        // the channel width of pips_chanff_bwd_finish's callers

// ------------------------------------------------------------ 1: LN rows
// xa[row] = LN(x[row]) * scale + bias in T; stats[row] = mu, stats[R + row] = rsig
template <int D, typename T>
__global__ void __launch_bounds__(32 * kLnRows)
chanff_bwd_ln(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ xa, float* __restrict__ stats,
              int R) {
  ln_row_pass<D>(x, scale, bias, xa, stats, R);
}

// ------------------------------------------------------------ 5: column sums
// Blocks first: out[c] = sum over row tiles b (in order) of the partials'
// column c (3D columns of part_d: LN scale, LN bias, b2; F of part_f: b1).
// Then, with split > 1, dw1 and dw2 = the sum over splits s (in order) of
// wsplit[s][0] and wsplit[s][1], a float4 a thread.
template <int D>
__global__ void chanff_bwd_colsum(const float* __restrict__ part_d, const float* __restrict__ part_f,
                                  float* __restrict__ dg, float* __restrict__ db,
                                  float* __restrict__ db2, float* __restrict__ db1,
                                  const float4* __restrict__ wsplit, float4* __restrict__ dw1,
                                  float4* __restrict__ dw2, int nblk, int F, int split) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int ncol = 3 * D + F;
  if (c < 3 * D) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_d[(size_t)b * 3 * D + c];
    float* out = c < D ? dg : (c < 2 * D ? db : db2);
    out[c % D] = s;
  } else if (c < ncol) {
    const int f = c - 3 * D;
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_f[(size_t)b * F + f];
    db1[f] = s;
  } else if (split > 1) {
    const size_t per = (size_t)D * F / 4, q = (size_t)(c - ncol);
    if (q >= 2 * per) return;
    const size_t which = q / per, i = q % per;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < split; ++s) {
      const float4 p = wsplit[((size_t)s * 2 + which) * per + i];
      v = make_float4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
    }
    (which ? dw2 : dw1)[i] = v;
  }
}

template <int D>
cudaError_t launch_colsum(const float* part_d, const float* part_f, float* dg, float* db,
                          float* db2, float* db1, const float* wsplit, float* dw1, float* dw2,
                          int nblk, int F, int split, cudaStream_t s) {
  const long n = 3L * D + F + (split > 1 ? 2L * D * F / 4 : 0);
  chanff_bwd_colsum<D><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part_d, part_f, dg, db, db2, db1, reinterpret_cast<const float4*>(wsplit),
      reinterpret_cast<float4*>(dw1), reinterpret_cast<float4*>(dw2), nblk, F, split);
  return cudaGetLastError();
}

// the weight-grad products' tiles: dw1 (D, F) first, then dw2 (F, D)
__host__ __device__ inline int wgrad_tiles(int D, int F) {
  return 2 * (D / kTileCols) * ((F + kTileCols - 1) / kTileCols);
}

// rows row0 .. of columns n0 .. n0 + 127 of a (R, D) tensor into dst
// [128][kLdx] by 16-byte cp.async, zeros past R: thread tid of n's copies
template <int D, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int row0, int n0,
                                           int R, int tid, int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  for (int q = tid; q < kTileRows * kTileCols / kPer; q += n) {
    const int r = q / (kTileCols / kPer), c = (q % (kTileCols / kPer)) * kPer;
    const bool ok = row0 + r < R;
    cp_async_16z(dst + r * kLdx + c, ok ? src + (size_t)(row0 + r) * D + n0 + c : src, ok);
  }
}

// the dxa product's epilogue, the LN backward, on a tile of rows row0 ..,
// columns n0 .. of D, one block of a cluster of D / 128 that share the rows:
// dxn = dxa * scale, xn = (x - mu) * rsig; the row sums of dxn and dxn * xn
// over the tile's columns (a half-warp's shuffles), then over the cluster in
// rank order through distributed shared memory; dx = dy + rsig (dxn - m1 -
// xn m2) in T; the tile's column sums of dxa * xn, dxa and dy into part_d
// (red: 8 x 3 x 128 floats). xs and dys: the tile's x and dy as stage_rows
// left them in shared memory. Every thread of the block calls it (the
// cluster barriers); only those with `epi` work.
template <int D, typename T, class Acc>
__device__ __forceinline__ void dxa_epilogue(Acc acc, bool epi, const T* xs, const T* dys,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ stats, T* __restrict__ dx,
                                             float* __restrict__ part_d, float* red, int n0,
                                             int row0, int R) {
  constexpr int kCluster = D / kTileCols;  // the blocks of the row tile
  __shared__ float rowpart[kTileRows][2];  // this block's row sums of dxn and dxn * xn
  __shared__ float4 rowstat[kTileRows];     // mu, rsig and the row means m1, m2
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, ty = t / 16, tx = t % 16, warp = t / 32;
  float sc[8];
  if (epi) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = scale[n0 + own(tx, j)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + own(ty, i);
      const float mu = row < R ? stats[row] : 0.0f, rs = row < R ? stats[R + row] : 0.0f;
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 xv = load4(xs + own(ty, i) * kLdx + 64 * h + 4 * tx);
        const float4 dv = acc(i, h);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ds[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float d = ds[jj] * sc[4 * h + jj];
          s1 += d;
          s2 += d * ((xs[jj] - mu) * rs);
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (tx == 0) {
        rowpart[own(ty, i)][0] = s1;
        rowpart[own(ty, i)][1] = s2;
        rowstat[own(ty, i)] = make_float4(mu, rs, 0.0f, 0.0f);
      }
    }
  }
  cluster.sync();
  if (t < kTileRows) {  // the row means over the cluster's D columns, in rank order
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* p = cluster.map_shared_rank(&rowpart[0][0], r) + 2 * t;
      t1 += p[0];
      t2 += p[1];
    }
    rowstat[t].z = t1 / D;
    rowstat[t].w = t2 / D;
  }
  cluster.sync();  // no row partials are read past here; rowstat is complete
  if (!epi) return;

  float cp[3][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cp[0][j] = cp[1][j] = cp[2][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + own(ty, i);
    const float4 st = rowstat[own(ty, i)];  // mu, rsig, m1, m2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = own(ty, i) * kLdx + 64 * h + 4 * tx;  // rows past R hold zeros
      const float4 xv = load4(xs + c), yv = load4(dys + c), dv = acc(i, h);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ys[4] = {yv.x, yv.y, yv.z, yv.w};
      const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
      float out[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * h + jj;
        const float xn = (xs[jj] - st.x) * st.y;
        out[jj] = ys[jj] + st.y * (ds[jj] * sc[j] - st.z - xn * st.w);
        cp[0][j] += ds[jj] * xn;
        cp[1][j] += ds[jj];
        cp[2][j] += ys[jj];
      }
      if (row < R)
        store4(dx + (size_t)row * D + n0 + 64 * h + 4 * tx,
               make_float4(out[0], out[1], out[2], out[3]));
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cp[k][j] += __shfl_xor_sync(0xffffffffu, cp[k][j], 16);
      if (t % 32 < 16) red[(warp * 3 + k) * kTileCols + own(tx, j)] = cp[k][j];
    }
  named_sync(1, kEpi);
  for (int j = t; j < 3 * kTileCols; j += kEpi) {
    const int k = j / kTileCols, c = j % kTileCols;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kEpi / 32; ++w) s += red[(w * 3 + k) * kTileCols + c];
    part_d[((size_t)blockIdx.y * 3 + k) * D + n0 + c] = s;
  }
}

// ======================================================= bf16: wgmma, TMA ring
namespace tc {
// ---- 2: the activation products
constexpr int kActStages = 6;
using ActRing = Ring<kActStages>;
static_assert(2 * kTileF32 + kEpi / 32 * kTileCols * 4 <= kActStages * kStageBytes,
              "a1, dg1 and the column sums staged over the ring");

// grid (ceil(F / 128), ceil(R / 128)). xa_map, dy_map: (R, D) in boxes of
// 128 rows; w1_map: (D, F) in boxes of 64; w2_map: (F, D) in boxes of 128.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_bwd_act(const __grid_constant__ CUtensorMap xa_map, const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
               const float* __restrict__ b1, bf16* __restrict__ g1, bf16* __restrict__ da1,
               float* __restrict__ part_f, int R, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ActRing ring(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  constexpr int kSteps = D / BK;  // of each product; a1's first, then dg1's
  if (tid == 0) ring.init();
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      tma_prefetch_map(&xa_map);
      tma_prefetch_map(&dy_map);
      tma_prefetch_map(&w1_map);
      tma_prefetch_map(&w2_map);
      for (int i = 0; i < 2 * kSteps; ++i) {
        unsigned char* st = ring.acquire(i);
        const int k0 = (i % kSteps) * BK;
        if (i < kSteps) {
          load_k(st, &xa_map, k0, row0, ring.bar(i));
          load_mn(st + kStageA, &w1_map, f0, k0, ring.bar(i));
        } else {
          load_k(st, &dy_map, k0, row0, ring.bar(i));
          load_k(st + kStageA, &w2_map, k0, f0, ring.bar(i));
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float* a1s = reinterpret_cast<float*>(ring.tiles);
  float* dgs = reinterpret_cast<float*>(ring.tiles + kTileF32);
  {
    float a1[64], dg[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) a1[j] = dg[j] = 0.0f;
    consume<0, 1>(ring, a1, 0, kSteps, wg);
    consume<0, 0>(ring, dg, kSteps, 2 * kSteps, wg);
    named_sync(1, kConsumers);  // every warpgroup's products are done: the ring is free
    stage_acc(a1s, a1, wg);
    stage_acc(dgs, dg, wg);
  }
  named_sync(1, kConsumers);
  act_epilogue<bf16>(Staged{a1s}, Staged{dgs}, b1, g1, da1, part_f,
                     reinterpret_cast<float*>(ring.tiles + 2 * kTileF32), f0, row0, R, F);
}

// ---- 3: dxa and the LN backward
constexpr int kDxaStages = 5;
using DxaRing = Ring<kDxaStages>;
constexpr int kRowsBf16 = kTileRows * kLdx * 2;  // 34,816: a staged x or dy tile
static_assert(kTileF32 + 2 * kRowsBf16 + kEpi / 32 * 3 * kTileCols * 4 <=
                  kDxaStages * kStageBytes,
              "dxa, x, dy and the column sums staged over the ring");

// grid (D / 128, ceil(R / 128)), clusters of the D / 128 along x.
// da1_map: (R, F), w1k_map: (D, F), both in boxes of 128 rows.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_bwd_dxa(const __grid_constant__ CUtensorMap da1_map,
               const __grid_constant__ CUtensorMap w1k_map, const bf16* __restrict__ x,
               const bf16* __restrict__ dy, const float* __restrict__ scale,
               const float* __restrict__ stats, bf16* __restrict__ dx, float* __restrict__ part_d,
               int R, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DxaRing ring(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  const int steps = F / BK;
  const bool consumer = warp < kProducerWarp;
  if (tid == 0) ring.init();
  __syncthreads();

  float* dxas = reinterpret_cast<float*>(ring.tiles);
  bf16* xs = reinterpret_cast<bf16*>(ring.tiles + kTileF32);
  bf16* dys = xs + kTileRows * kLdx;
  if (!consumer) {
    if (lane == 0) {
      tma_prefetch_map(&da1_map);
      tma_prefetch_map(&w1k_map);
      for (int i = 0; i < steps; ++i) {
        unsigned char* st = ring.acquire(i);
        load_k(st, &da1_map, i * BK, row0, ring.bar(i));
        load_k(st + kStageA, &w1k_map, i * BK, n0, ring.bar(i));
      }
    }
  } else {
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    consume<0, 0>(ring, acc, 0, steps, wg);
    named_sync(1, kConsumers);  // every warpgroup's products are done: the ring is free
    stage_rows<D>(xs, x, row0, n0, R, tid, kConsumers);
    stage_rows<D>(dys, dy, row0, n0, R, tid, kConsumers);
    stage_acc(dxas, acc, wg);
    cp_async_wait_all();
    named_sync(1, kConsumers);
  }
  dxa_epilogue<D, bf16>(Staged{dxas}, consumer, xs, dys, scale, stats, dx, part_d,
                     reinterpret_cast<float*>(ring.tiles + kTileF32 + 2 * kRowsBf16), n0, row0,
                     R);
}

// ---- 4: the weight-grad products
constexpr int kWgradStages = 6;
using WgradRing = Ring<kWgradStages>;

// grid (wgrad_tiles(D, F), split): dw1 (D, F) = xa^T da1, then dw2 (F, D) =
// g1^T dy, K = R cut into `split` runs; with split > 1 run s writes
// wsplit[s][0 or 1]. All four maps in boxes of 64 rows (MN-major tiles).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_bwd_wgrad(const __grid_constant__ CUtensorMap xa_map,
                 const __grid_constant__ CUtensorMap da1_map,
                 const __grid_constant__ CUtensorMap g1_map,
                 const __grid_constant__ CUtensorMap dy_map, float* __restrict__ dw1,
                 float* __restrict__ dw2, float* __restrict__ wsplit, int R, int F, int split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradRing ring(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = wgrad_tiles(D, F) / 2;
  const bool first = (int)blockIdx.x < half;
  const int t = first ? blockIdx.x : blockIdx.x - half;
  const int M = first ? D : F, N = first ? F : D;
  const int tiles_n = (N + kTileCols - 1) / kTileCols;
  const int m0 = (t / tiles_n) * kTileRows, n0 = (t % tiles_n) * kTileCols;
  int i0, i1;
  split_range((R + BK - 1) / BK, split, blockIdx.y, i0, i1);
  if (tid == 0) ring.init();
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      const CUtensorMap* am = first ? &xa_map : &g1_map;
      const CUtensorMap* bm = first ? &da1_map : &dy_map;
      tma_prefetch_map(am);
      tma_prefetch_map(bm);
      for (int i = i0; i < i1; ++i) {
        unsigned char* st = ring.acquire(i - i0);
        load_mn(st, am, m0, i * BK, ring.bar(i - i0));
        load_mn(st + kStageA, bm, n0, i * BK, ring.bar(i - i0));
      }
    }
    return;
  }
  const int wg = warp / 4, wl = warp % 4, gq = lane / 4, tq = lane % 4;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  consume<1, 1>(ring, acc, 0, i1 - i0, wg);

  float* out = split == 1 ? (first ? dw1 : dw2)
                          : wsplit + ((size_t)blockIdx.y * 2 + (first ? 0 : 1)) * D * F;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int m = m0 + 64 * wg + 16 * wl + gq + 8 * hi;
    if (m >= M) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = n0 + 8 * n + 2 * tq;
      if (c < N)
        *reinterpret_cast<float2*>(out + (size_t)m * N + c) =
            make_float2(acc[4 * n + 2 * hi], acc[4 * n + 2 * hi + 1]);
    }
  }
}

// the weight-grad products on bf16 scratch: xa (R, D), g1 and da1 (R, F), dy (R, D)
template <int D>
cudaError_t launch_wgrad(const bf16* xa, const bf16* g1, const bf16* da1, const bf16* dy,
                         float* dw1, float* dw2, float* wsplit, int R, int F, int split,
                         cudaStream_t s) {
  CUtensorMap xa_map, da1_map, g1_map, dy_map;
  cudaError_t err = make_map_2d_bf16(&xa_map, xa, D, R, D * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&da1_map, da1, F, R, (uint64_t)F * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&g1_map, g1, F, R, (uint64_t)F * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&dy_map, dy, D, R, D * 2, 64);
  if (err == cudaSuccess) err = set_smem(chanff_bwd_wgrad<D>, WgradRing::kSmem);
  if (err != cudaSuccess) return err;
  chanff_bwd_wgrad<D><<<dim3(wgrad_tiles(D, F), split), kThreads, WgradRing::kSmem, s>>>(
      xa_map, da1_map, g1_map, dy_map, dw1, dw2, wsplit, R, F, split);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const bf16* x, const bf16* dy, const float* scale, const float* bias,
                   const bf16* w1, const float* b1, const bf16* w2, bf16* dx, float* dg,
                   float* db, float* dw1, float* db1, float* dw2, float* db2, bf16* xa, bf16* g1,
                   bf16* da1, float* stats, float* part_d, float* part_f, float* wsplit, int R,
                   int F, int split, cudaStream_t s) {
  const int nblk = (R + kTileRows - 1) / kTileRows;
  chanff_bwd_ln<D, bf16><<<(R + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(x, scale, bias,
                                                                               xa, stats, R);
  cudaError_t err = cudaGetLastError();
  CUtensorMap xa_map, dy_map, w1_map, w2_map, da1_map, w1k_map;
  if (err == cudaSuccess) err = make_map_2d_bf16(&xa_map, xa, D, R, D * 2, kTileRows);
  if (err == cudaSuccess) err = make_map_2d_bf16(&dy_map, dy, D, R, D * 2, kTileRows);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w1_map, w1, F, D, (uint64_t)F * 2, 64);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w2_map, w2, D, F, D * 2, kTileCols);
  if (err == cudaSuccess) err = make_map_2d_bf16(&da1_map, da1, F, R, (uint64_t)F * 2, kTileRows);
  if (err == cudaSuccess) err = make_map_2d_bf16(&w1k_map, w1, F, D, (uint64_t)F * 2, kTileCols);
  if (err == cudaSuccess) err = set_smem(chanff_bwd_act<D>, ActRing::kSmem);
  if (err == cudaSuccess) err = set_smem(chanff_bwd_dxa<D>, DxaRing::kSmem);
  if (err != cudaSuccess) return err;
  chanff_bwd_act<D><<<dim3((F + kTileCols - 1) / kTileCols, nblk), kThreads, ActRing::kSmem, s>>>(
      xa_map, dy_map, w1_map, w2_map, b1, g1, da1, part_f, R, F);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_clusters(chanff_bwd_dxa<D>, dim3(D / kTileCols, nblk), dim3(D / kTileCols),
                          kThreads, DxaRing::kSmem, s, da1_map, w1k_map, x, dy, scale, stats, dx,
                          part_d, R, F);
  if (err == cudaSuccess) err = launch_wgrad<D>(xa, g1, da1, dy, dw1, dw2, wsplit, R, F, split, s);
  if (err != cudaSuccess) return err;
  return launch_colsum<D>(part_d, part_f, dg, db, db2, db1, wsplit, dw1, dw2, nblk, F, split, s);
}
}  // namespace tc

// ================================================ f32: register-tiled SGEMMs
namespace simt {
// ---- 2: the activation products; grid (ceil(F / 128), ceil(R / 128))
constexpr size_t kActSmem = (size_t)kStages * 4 * kOp * sizeof(float);

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_bwd_act_f32(const float* __restrict__ xa, const float* __restrict__ dy,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, float* __restrict__ g1, float* __restrict__ da1,
                   float* __restrict__ part_f, int R, int F) {
  extern __shared__ __align__(16) float sm[];  // [kStages][xa, w1, dy, w2][kOp]
  const int f0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  const Operand xa_op{xa, D, R, D}, dy_op{dy, D, R, D};
  const Operand w1_op{w1, F, F, D}, w2_op{w2, D, F, D};
  float a1[8][8], dg[8][8];
  zero(a1);
  zero(dg);
  pipeline(
      0, D / BK,
      [&](int slot, int k0) {
        float* s = sm + slot * 4 * kOp;
        stage_a<true>(s, xa_op, row0, k0);
        stage_b<false>(s + kOp, w1_op, f0, k0);
        stage_a<true>(s + 2 * kOp, dy_op, row0, k0);
        stage_b<true>(s + 3 * kOp, w2_op, f0, k0);
      },
      [&](int slot) {
        const float* s = sm + slot * 4 * kOp;
        fma_tiles<true>(a1, s, s + kOp);
        fma_tiles<true>(dg, s + 2 * kOp, s + 3 * kOp);
      });
  act_epilogue<float>(Regs{a1}, Regs{dg}, b1, g1, da1, part_f, sm, f0, row0, R, F);
}

// ---- 3: dxa and the LN backward; grid (D / 128, ceil(R / 128)), clusters of D / 128
constexpr size_t kRowsF32 = (size_t)kTileRows * kLdx;  // floats of a staged x or dy tile
// the stages, then x, dy and the column sums over them
constexpr size_t kDxaSmem = 2 * kRowsF32 * 4 + kEpi / 32 * 3 * kTileCols * 4;
static_assert(kDxaSmem >= (size_t)kStages * 2 * kOp * sizeof(float), "the stages fit");

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
chanff_bwd_dxa_f32(const float* __restrict__ da1, const float* __restrict__ w1,
                   const float* __restrict__ x, const float* __restrict__ dy,
                   const float* __restrict__ scale, const float* __restrict__ stats,
                   float* __restrict__ dx, float* __restrict__ part_d, int R, int F) {
  extern __shared__ __align__(16) float sm[];  // [kStages][da1, w1][kOp]
  const int n0 = blockIdx.x * kTileCols, row0 = blockIdx.y * kTileRows;
  const Operand da_op{da1, F, R, F}, w1_op{w1, F, D, F};
  float acc[8][8];
  zero(acc);
  pipeline(
      0, F / BK,
      [&](int slot, int k0) {
        float* s = sm + slot * 2 * kOp;
        stage_a<true>(s, da_op, row0, k0);
        stage_b<true>(s + kOp, w1_op, n0, k0);
      },
      [&](int slot) {
        const float* s = sm + slot * 2 * kOp;
        fma_tiles<true>(acc, s, s + kOp);
      });
  stage_rows<D>(sm, x, row0, n0, R, threadIdx.x, kThreads);
  stage_rows<D>(sm + kRowsF32, dy, row0, n0, R, threadIdx.x, kThreads);
  cp_async_wait_all();
  __syncthreads();
  dxa_epilogue<D, float>(Regs{acc}, true, sm, sm + kRowsF32, scale, stats, dx, part_d,
                      sm + 2 * kRowsF32, n0, row0, R);
}

// ---- 4: the weight-grad products; grid (wgrad_tiles(D, F), split), as tc's
constexpr size_t kWgradSmem = (size_t)kStages * 2 * kOp * sizeof(float);

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
chanff_bwd_wgrad_f32(const float* __restrict__ xa, const float* __restrict__ da1,
                     const float* __restrict__ g1, const float* __restrict__ dy,
                     float* __restrict__ dw1, float* __restrict__ dw2, float* __restrict__ wsplit,
                     int R, int F, int split) {
  extern __shared__ __align__(16) float sm[];  // [kStages][A, B][kOp]
  const int half = wgrad_tiles(D, F) / 2;
  const bool first = (int)blockIdx.x < half;
  const int tile = first ? blockIdx.x : blockIdx.x - half;
  const int M = first ? D : F, N = first ? F : D;
  const int tiles_n = (N + kTileCols - 1) / kTileCols;
  const int m0 = (tile / tiles_n) * kTileRows, n0 = (tile % tiles_n) * kTileCols;
  const Operand a_op = first ? Operand{xa, D, D, R} : Operand{g1, F, F, R};
  const Operand b_op = first ? Operand{da1, F, F, R} : Operand{dy, D, D, R};
  int i0, i1;
  split_range((R + BK - 1) / BK, split, blockIdx.y, i0, i1);
  float acc[8][8];
  zero(acc);
  pipeline(
      i0, i1,
      [&](int slot, int k0) {
        float* s = sm + slot * 2 * kOp;
        stage_a<false>(s, a_op, m0, k0);
        stage_b<false>(s + kOp, b_op, n0, k0);
      },
      [&](int slot) {
        const float* s = sm + slot * 2 * kOp;
        fma_tiles<false>(acc, s, s + kOp);
      });

  float* out = split == 1 ? (first ? dw1 : dw2)
                          : wsplit + ((size_t)blockIdx.y * 2 + (first ? 0 : 1)) * D * F;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + own(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      if (c < N)
        *reinterpret_cast<float4*>(out + (size_t)m * N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

template <int D>
cudaError_t launch(const float* x, const float* dy, const float* scale, const float* bias,
                   const float* w1, const float* b1, const float* w2, float* dx, float* dg,
                   float* db, float* dw1, float* db1, float* dw2, float* db2, float* xa, float* g1,
                   float* da1, float* stats, float* part_d, float* part_f, float* wsplit, int R,
                   int F, int split, cudaStream_t s) {
  const int nblk = (R + kTileRows - 1) / kTileRows;
  cudaError_t err = set_smem(chanff_bwd_act_f32<D>, kActSmem);
  if (err == cudaSuccess) err = set_smem(chanff_bwd_dxa_f32<D>, kDxaSmem);
  if (err == cudaSuccess) err = set_smem(chanff_bwd_wgrad_f32<D>, kWgradSmem);
  if (err != cudaSuccess) return err;
  chanff_bwd_ln<D, float><<<(R + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(x, scale, bias,
                                                                                xa, stats, R);
  chanff_bwd_act_f32<D><<<dim3((F + kTileCols - 1) / kTileCols, nblk), kThreads, kActSmem, s>>>(
      xa, dy, w1, b1, w2, g1, da1, part_f, R, F);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_clusters(chanff_bwd_dxa_f32<D>, dim3(D / kTileCols, nblk), dim3(D / kTileCols),
                          kThreads, kDxaSmem, s, da1, w1, x, dy, scale, stats, dx, part_d, R, F);
  if (err != cudaSuccess) return err;
  chanff_bwd_wgrad_f32<D><<<dim3(wgrad_tiles(D, F), split), kThreads, kWgradSmem, s>>>(
      xa, da1, g1, dy, dw1, dw2, wsplit, R, F, split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum<D>(part_d, part_f, dg, db, db2, db1, wsplit, dw1, dw2, nblk, F, split, s);
}
}  // namespace simt

}  // namespace

extern "C" {

// Shapes the kernel takes: D == 256 or 512, F a positive multiple of 64, R >= 1;
// part_rows == 128, the rows of the row tiles the partials are summed over;
// 1 <= split <= 16, the weight-grad products' K splits. dtype_code 0 =
// float32, 1 = bfloat16 (x, dy, w1, w2, dx and xa, g1, da1). Scratch the
// caller allocates: xa (R, D), g1 and da1 (R, F) in the compute dtype; f32
// stats (2, R), part_d (ceil(R / 128), 3, D), part_f (ceil(R / 128), F), and
// with split > 1 wsplit (split, 2, D * F) (else it may be null). All pointers
// 16-byte aligned and contiguous.
int pips_chanff_bwd(const void* x, const void* dy, const void* ln_scale, const void* ln_bias,
                    const void* w1, const void* b1, const void* w2, void* dx, void* dg, void* db,
                    void* dw1, void* db1, void* dw2, void* db2, void* xa, void* g1, void* da1,
                    void* stats, void* part_d, void* part_f, void* wsplit, int R, int D, int F,
                    int part_rows, int split, int dtype_code, int device, void* stream) {
  if ((D != 256 && D != 512) || F <= 0 || F % 64 != 0 || R <= 0 || part_rows != kTileRows ||
      split < 1 || split > kMaxSplit || (split > 1 && wsplit == nullptr) ||
      (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(ln_scale);
  const float* bi = static_cast<const float*>(ln_bias);
  const float* bb1 = static_cast<const float*>(b1);
  float* f[] = {static_cast<float*>(dg),   static_cast<float*>(db),    static_cast<float*>(dw1),
                static_cast<float*>(db1),  static_cast<float*>(dw2),   static_cast<float*>(db2),
                static_cast<float*>(stats), static_cast<float*>(part_d), static_cast<float*>(part_f),
                static_cast<float*>(wsplit)};
  if (dtype_code == 1) {
    const auto launch = D == 256 ? &tc::launch<256> : &tc::launch<512>;
    return (int)launch(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), sc, bi,
                       static_cast<const bf16*>(w1), bb1, static_cast<const bf16*>(w2),
                       static_cast<bf16*>(dx), f[0], f[1], f[2], f[3], f[4], f[5],
                       static_cast<bf16*>(xa), static_cast<bf16*>(g1), static_cast<bf16*>(da1),
                       f[6], f[7], f[8], f[9], R, F, split, s);
  }
  const auto launch = D == 256 ? &simt::launch<256> : &simt::launch<512>;
  return (int)launch(static_cast<const float*>(x), static_cast<const float*>(dy), sc, bi,
                     static_cast<const float*>(w1), bb1, static_cast<const float*>(w2),
                     static_cast<float*>(dx), f[0], f[1], f[2], f[3], f[4], f[5],
                     static_cast<float*>(xa), static_cast<float*>(g1), static_cast<float*>(da1),
                     f[6], f[7], f[8], f[9], R, F, split, s);
}

// The weight-grad products and the column sums alone, bf16, D = 512, on
// scratch in pips_chanff_bwd's layout that another kernel wrote, its partials
// in nblk row tiles of part_rows rows (chanff_chunk.cu's 64).
int pips_chanff_bwd_finish(const void* xa, const void* g1, const void* da1, const void* dy,
                           void* dg, void* db, void* dw1, void* db1, void* dw2, void* db2,
                           const void* part_d, const void* part_f, void* wsplit, int R, int F,
                           int nblk, int part_rows, int split, int device, void* stream) {
  if (F <= 0 || F % 64 != 0 || R <= 0 || part_rows <= 0 ||
      nblk != (R + part_rows - 1) / part_rows || split < 1 || split > kMaxSplit ||
      (split > 1 && wsplit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(wsplit);
  err = tc::launch_wgrad<kFinishD>(static_cast<const bf16*>(xa), static_cast<const bf16*>(g1),
                                   static_cast<const bf16*>(da1), static_cast<const bf16*>(dy),
                                   static_cast<float*>(dw1), static_cast<float*>(dw2), ws, R, F,
                                   split, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_colsum<kFinishD>(
      static_cast<const float*>(part_d), static_cast<const float*>(part_f),
      static_cast<float*>(dg), static_cast<float*>(db), static_cast<float*>(db2),
      static_cast<float*>(db1), ws, static_cast<float*>(dw1), static_cast<float*>(dw2), nblk, F,
      split, s);
}

}  // extern "C"
