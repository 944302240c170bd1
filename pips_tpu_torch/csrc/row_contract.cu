// A batched, strided contraction over rows, the four probe kernels of
// tools/probe_mosaic_ops.py (the pallas_calls at :46, :67, :89 and :110),
// which checked Mosaic lowerings for the stem weight-gradient design:
//   out[g, c, o] = sum_{i < R} a[g * a_bs + i * a_rs + c] * b[g * b_bs + i * b_rs + o]
// for g < G, c < CA, o < CB, bf16 operands, f32 products and sums, f32 out
// (G, CA, CB) contiguous. Probes A, A2 and B (two contracting dims; both
// operands collapsed to 2-D in the kernel; a minor-dim split reshape) are one
// memory layout here: G = 1, R = 24 * 256 rows of a (6 lanes) and b (64).
// Probe C (28 (24, 6) tiles concatenated along lanes, then one product) is
// G = 28 batches of R = 24 rows: a's batch stride is one pixel (6), b's is 0.
//
// What bounds it on an H100: bytes. Probe A reads 0.86 MB (0.26 us at
// 3.35 TB/s) for 4.7 MFLOP; probe C 0.05 MB (its a tiles, one row of b, the
// f32 output; 0.02 us). Both bounds lie below the cost of one launch (a few
// microseconds from launch to launch on the card), so this kernel can never
// reach half of its bound: what it can do is take one launch and one round
// trip to memory.
//
// Design. One launch per call. The rows are cut into `splits` equal runs
// (the wrapper's plan: at most 8, so that a run's blocks form one portable
// thread-block cluster); grid (splits, G), a cluster per batch g.
//   Fast path (row_contract_tc: CA <= 8 and even, CB = 64, rows aligned for
//   4-byte copies of a and a TMA map over b, at most 1024 rows a block): each
//   block puts all of its rows in flight at once into shared memory, b's by
//   TMA boxes of up to 256 rows (contiguous in A/A2/B, 32 KB apart in C),
//   128-byte swizzled so that the products' ldmatrix.trans reads no two rows
//   from one bank (dense 128-byte rows put all eight rows of a matrix in one
//   bank: on the card that cost 2.5 us of probe A's time); a's contiguous range
//   (A/A2/B) by one cp.async.bulk, its strided 12-byte rows (C) by 4-byte
//   cp.async, all on one mbarrier. Then the products from shared memory on
//   mma.sync m16n8k16 with M = b's lanes (ldmatrix.trans of the staged b
//   rows), N = a's lanes padded to 8, K = rows padded to 16 with zeros: 16
//   warps, each an m-tile of 16 outputs o and a quarter of the k-steps on
//   two accumulators by turns, their tiles added in a fixed order in shared
//   memory. A single block of at most 64 rows (probe C) runs 8 warps, four
//   of which take all the k-steps and write the output from their
//   accumulators. SIMT FMAs (the general path's product) would take 12 FMAs
//   and 3 loads a row for each thread; the general path on probe A's rows
//   takes 17x the fast path's time.
//   General path (row_contract_simt, any CA, CB, strides): each thread owns
//   4 outputs at a time in registers and walks its block's rows from global
//   memory (L1 serves the repeats).
// The cluster's partial sums are added in the same launch in a fixed order.
// Fast path: block r owns a share of the outputs; every block stores its
// sums of each share into the owner's shared memory (distributed shared
// memory stores, after a cluster barrier whose arrive each block makes as it
// starts), and after a second barrier each owner adds what it received in
// rank order. General path: an f32 scratch (splits, G, CA, CB) in global
// memory, read after a cluster barrier. No atomics: two calls give the same
// bits. With one split the launch is a plain one: the block writes the output
// itself.
//
// Plain C ABI (loaded with ctypes): pips_row_contract returns
// cudaGetLastError() after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;       // 256 for a single block of few rows (the direct write)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;      // a cluster's blocks: the portable cluster size
constexpr int kFastRows = 1024;    // rows a fast-path block stages at most
constexpr int kFastCA = 8;         // a's lanes at most on the fast path: one n8 tile
constexpr int kFastCB = 64;        // b's lanes on the fast path: 128-byte rows, one TMA box wide
constexpr int kBoxRows = 256;      // rows of b a TMA box holds at most
constexpr int kGridY = 65535;      // batches along grid y; the rest along z
constexpr int kOutPerThread = 4;   // the general path's outputs a thread at a time
constexpr int kDirectSteps = 4;    // k-steps one warp takes whole, writing its outputs itself
// the warps' partial tiles (kWarps / (CB / 16) of CA x CB f32); the cluster's
// partial sums of this block's share of the outputs (splits x the share)
constexpr size_t kRedBytes = (size_t)kWarps / (kFastCB / 16) * kFastCA * kFastCB * 4;
constexpr size_t kRecvBytes = (size_t)(kFastCA * kFastCB + kMaxSplits) * 4;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// shared memory of a fast-path block: 1024 bytes to align b's rows, b's rows
// (128-byte swizzled), a's rows, red, recv, one mbarrier
__host__ __device__ constexpr size_t fast_smem(int rows, int CA) {
  return 1024 + (size_t)rows * kFastCB * 2 + align16((size_t)rows * CA * 2) + kRedBytes +
         kRecvBytes + 16;
}

// cluster barriers: arrive (relaxed: this block has started) and wait; a
// default arrive releases this block's writes to distributed shared memory,
// the wait acquires the other blocks'
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the block's rows into shared memory, every copy in flight at once: b's by
// TMA boxes of box_rows rows (b_map's rows: b's rows of every batch, those of
// batch g from row g * b_gstep; rows past the tensor read as zero) into bs,
// 128-byte swizzled; a's n rows into as [n][CA], a contiguous 16-byte aligned
// range by one bulk copy, strided rows by 4-byte cp.async (each thread waits
// for its own with cp_async_wait_all); the TMA and bulk copies on bar
__device__ __forceinline__ void stage_rows(unsigned char* bs, bf16* as, const CUtensorMap* b_map,
                                           int b_row, int rows_per, const bf16* ag, int n,
                                           int CA, int a_rs, uint64_t* bar) {
  const int box_rows = min(rows_per, kBoxRows);
  const uint32_t a_bytes = (uint32_t)n * CA * 2;
  const bool a_bulk =
      a_rs == CA && (reinterpret_cast<uintptr_t>(ag) & 15) == 0 && a_bytes % 16 == 0;
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (uint32_t)rows_per * kFastCB * 2 + (a_bulk ? a_bytes : 0));
    for (int r = 0; r < rows_per; r += box_rows)
      tma_load_2d(bs + r * 128, b_map, 0, b_row + r, bar);
    if (a_bulk) bulk_load(as, ag, a_bytes, bar);
  }
  if (!a_bulk)
    for (int q = threadIdx.x; q < n * (CA / 2); q += blockDim.x) {
      const int r = q / (CA / 2), j = q % (CA / 2);
      cp_async_4(as + (size_t)r * CA + 2 * j, ag + (size_t)r * a_rs + 2 * j);
    }
}

// grid (splits, G) as (x, y + z * kGridY), clusters of `splits` along x;
// rows_per a multiple of 16 and of its TMA boxes' rows; CB = kFastCB
__global__ void __launch_bounds__(kThreads) row_contract_tc(
    __grid_constant__ const CUtensorMap b_map, const bf16* __restrict__ a,
    float* __restrict__ out, int G, int R, int CA, int a_bs, int a_rs, int b_gstep,
    int rows_per) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CB = kFastCB;
  const int g = blockIdx.z * gridDim.y + blockIdx.y;
  if (g >= G) return;  // whole clusters (they share y and z) leave together
  const int splits = gridDim.x, split = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nthreads = blockDim.x;
  const int i0 = split * rows_per, n = min(rows_per, R - i0);  // this block's rows, at least 1
  const int kp = (n + 15) / 16 * 16;                            // ... padded to whole k-steps
  unsigned char* bs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* as = reinterpret_cast<bf16*>(bs + (size_t)rows_per * CB * 2);
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(as) +
                                        align16((size_t)rows_per * CA * 2));
  float* recv = red + kRedBytes / 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(recv + kRecvBytes / 4);
  // the cluster's blocks meet before their partial sums cross: arrive now,
  // wait when they are ready
  if (splits > 1) cluster_arrive_relaxed();

  const bf16* ag = a + (size_t)g * a_bs + (size_t)i0 * a_rs;
  if (tid == 0) {
    tma_prefetch_map(&b_map);
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  stage_rows(bs, as, &b_map, g * b_gstep + i0, rows_per, ag, n, CA, a_rs, bar);
  // a's rows n .. kp - 1 are zero (stores beside the copies' range)
  for (int q = tid; q < (kp - n) * CA / 2; q += nthreads)
    reinterpret_cast<uint32_t*>(as + (size_t)n * CA)[q] = 0u;
  cp_async_wait_all();
  __syncthreads();  // the mbarrier is set up; a's rows and zeros are in place
  mbar_wait(bar, 0);
  if (kp > n) {  // b's rows n .. kp - 1 are zero too: past R they may hold the next batch's rows
    for (int q = tid; q < (kp - n) * CB / 8; q += nthreads)
      reinterpret_cast<uint4*>(bs + (size_t)n * CB * 2)[q] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // out^T (CB x CA) = b^T (CB x rows) a (rows x CA): warp (mt, kg) owns
  // outputs o0 .. o0 + 15 and the k-steps kg, kg + KG, ..., summed into two
  // accumulators by turns (two products in flight). A single block of few
  // rows (probe C) takes them in KG = 1 and writes the output from the
  // accumulators
  constexpr int MT = CB / 16;
  const bool direct = splits == 1 && kp / 16 <= kDirectSteps;
  const int KG = direct ? 1 : nthreads / 32 / MT;
  const int o0 = (warp % MT) * 16, kg = warp / MT;
  const int gq = lane / 4, tq = lane % 4;
  auto step = [&](int ks, float* d) {
    const int r0 = ks * 16;
    uint32_t af[4];  // A = b^T: rows o, k = rows of b, by ldmatrix.trans of the staged b rows
    ldmatrix_x4_trans(af[0], af[1], af[2], af[3],
                      reinterpret_cast<const bf16*>(
                          bs + swz128(r0 + (lane & 7) + 8 * (lane >> 4),
                                      o0 / 8 + ((lane >> 3) & 1))));
    uint32_t b0 = 0u, b1 = 0u;  // B = a: k = rows, n = lanes c (zero past CA)
    if (gq < CA) {
      const bf16* ac = as + (size_t)(r0 + 2 * tq) * CA + gq;
      b0 = bits(__halves2bfloat162(ac[0], ac[CA]));
      b1 = bits(__halves2bfloat162(ac[8 * CA], ac[9 * CA]));
    }
    mma_bf16(d, af, b0, b1);
  };
  float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int ks = kg; kg < KG && ks < kp / 16; ks += 2 * KG) {
    step(ks, d[0]);
    if (ks + KG < kp / 16) step(ks + KG, d[1]);
  }
  // d[0] + d[1]: outputs (o0 + gq, c = 2 tq, 2 tq + 1) and (o0 + gq + 8, the same c)
  const int nout = CA * CB;
  float* rk = direct ? out + (size_t)g * nout : red + (size_t)kg * nout;
  if (kg >= KG) return;  // direct: warps past the m-tiles took no k-step
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 2 * tq + (e & 1), o = o0 + gq + 8 * (e >> 1);
    if (c < CA) rk[c * CB + o] = d[0][e] + d[1][e];
  }
  if (direct) return;
  __syncthreads();
  // the block's sums, the warps' tiles added in k-group order. With one
  // split they are the output; with more, block r of the cluster owns
  // outputs r * share .. and receives every block's sums of them, in the
  // slot of the sender's rank (distributed shared memory stores: nothing
  // waits on them)
  const int share = (nout + splits - 1) / splits;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster_wait();  // every block of the cluster has started
  for (int j = tid; j < nout; j += nthreads) {
    float v = 0.0f;
    for (int k = 0; k < KG; ++k) v += red[k * nout + j];
    if (splits == 1) {
      out[(size_t)g * nout + j] = v;
    } else {
      const int r = j / share;
      cluster.map_shared_rank(recv, r)[split * share + j - r * share] = v;
    }
  }
  if (splits == 1) return;

  cluster_arrive();  // the sums sent are visible to their owners after the wait
  cluster_wait();
  const int j0 = split * share, j1 = min(nout, j0 + share);
  for (int j = j0 + tid; j < j1; j += nthreads) {
    float v = 0.0f;
    for (int k = 0; k < splits; ++k) v += recv[k * share + j - j0];
    out[(size_t)g * nout + j] = v;
  }
}

// any CA, CB and strides; grid and clusters as row_contract_tc's; part
// (splits, G, CA, CB) f32 with more than one split
__global__ void __launch_bounds__(kThreads) row_contract_simt(
    const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ out,
    float* __restrict__ part, int G, int R, int CA, int CB, int a_bs, int a_rs, int b_bs,
    int b_rs, int rows_per) {
  const int g = blockIdx.z * gridDim.y + blockIdx.y;
  if (g >= G) return;
  const int splits = gridDim.x, split = blockIdx.x;
  const int i0 = split * rows_per, i1 = min(R, i0 + rows_per);
  const int nout = CA * CB;
  const bf16* ag = a + (size_t)g * a_bs;
  const bf16* bg = b + (size_t)g * b_bs;
  float* dst = splits == 1 ? out + (size_t)g * nout : part + ((size_t)split * G + g) * nout;
  for (int jt = 0; jt < nout; jt += kThreads * kOutPerThread) {
    const bf16* ac[kOutPerThread];
    const bf16* bo[kOutPerThread];
    float acc[kOutPerThread];
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int j = min(jt + (int)threadIdx.x + k * kThreads, nout - 1);
      ac[k] = ag + j / CB;  // a's lane c
      bo[k] = bg + j % CB;  // b's lane o
      acc[k] = 0.0f;
    }
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const size_t ia = (size_t)i * a_rs, ib = (size_t)i * b_rs;
#pragma unroll
      for (int k = 0; k < kOutPerThread; ++k)
        acc[k] = fmaf(__bfloat162float(ac[k][ia]), __bfloat162float(bo[k][ib]), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int j = jt + (int)threadIdx.x + k * kThreads;
      if (j < nout) dst[j] = acc[k];
    }
  }
  if (splits == 1) return;

  __threadfence();
  cg::this_cluster().sync();  // every block's partials are in the scratch
  const int j0 = nout * split / splits, j1 = nout * (split + 1) / splits;
  for (int j = j0 + (int)threadIdx.x; j < j1; j += kThreads) {
    float v = 0.0f;
    for (int k = 0; k < splits; ++k) v += part[((size_t)k * G + g) * nout + j];
    out[(size_t)g * nout + j] = v;
  }
}

bool fast_ok(const void* a, const void* b, int CA, int CB, int a_bs, int a_rs, int b_bs,
             int b_rs, int rows_per) {
  const int box_rows = rows_per < kBoxRows ? rows_per : kBoxRows;
  return CA <= kFastCA && CA % 2 == 0 && CB == kFastCB &&
         reinterpret_cast<uintptr_t>(a) % 4 == 0 && a_bs % 2 == 0 && a_rs % 2 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && b_rs > 0 && b_rs % 8 == 0 &&
         b_bs % b_rs == 0 && rows_per % 16 == 0 && rows_per % box_rows == 0 &&
         rows_per <= kFastRows;
}

}  // namespace

extern "C" {

// a, b: bf16 with the element strides given (the lane stride 1, offsets below
// 2^31); out (G, CA, CB) float32 contiguous. The launch plan comes from the
// wrapper: fast (1: row_contract_tc, whose conditions are checked here; 0:
// row_contract_simt), splits blocks of rows_per rows each covering R (the last
// one at least one row); part (splits, G, CA, CB) float32 scratch for the
// general path with splits > 1, else unused (may be null). With one split
// the launch is a plain one, with more a cluster of `splits` blocks.
int pips_row_contract(const void* a, const void* b, void* out, void* part, int G, int R, int CA,
                      int CB, int a_bs, int a_rs, int b_bs, int b_rs, int fast, int splits,
                      int rows_per, int device, void* stream) {
  if (G <= 0 || R <= 0 || CA <= 0 || CB <= 0 || splits < 1 || splits > kMaxSplits ||
      rows_per <= 0 || (long)(splits - 1) * rows_per >= R || (long)splits * rows_per < R ||
      (fast && !fast_ok(a, b, CA, CB, a_bs, a_rs, b_bs, b_rs, rows_per)) ||
      (!fast && splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, G < kGridY ? G : kGridY, (G + kGridY - 1) / kGridY);
  // a single block of few rows writes from its accumulators with four warps
  // (row_contract_tc's direct path): half the threads start it sooner
  cfg.blockDim = dim3(fast && splits == 1 && rows_per <= kDirectSteps * 16 ? kThreads / 2
                                                                            : kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const bf16* ab = static_cast<const bf16*>(a);
  float* o = static_cast<float*>(out);
  if (fast) {
    // b as rows of 64 lanes b_rs apart, batch g's from row g * b_gstep
    const int b_gstep = b_bs / b_rs;
    CUtensorMap b_map;
    err = make_map_2d_bf16(&b_map, b, kFastCB, (uint64_t)(G - 1) * b_gstep + R,
                           (uint64_t)b_rs * 2, rows_per < kBoxRows ? rows_per : kBoxRows);
    if (err != cudaSuccess) return (int)err;
    cfg.dynamicSmemBytes = fast_smem(rows_per, CA);
    err = cudaFuncSetAttribute(row_contract_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, row_contract_tc, b_map, ab, o, G, R, CA, a_bs, a_rs, b_gstep,
                             rows_per);
  } else {
    err = cudaLaunchKernelEx(&cfg, row_contract_simt, ab, static_cast<const bf16*>(b), o,
                             static_cast<float*>(part), G, R, CA, CB, a_bs, a_rs, b_bs, b_rs,
                             rows_per);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
