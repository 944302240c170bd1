// Asynchronous copies between global and shared memory and the mbarriers
// that track them (sm_90), shared by the pipelined kernels (stem_wgrad.cu,
// mixer_probes.cu, conv3x3_stats.cu, row_contract.cu, chanff_bwd.cu):
//   TMA: one thread copies a 2D or 4D box of a bf16 tensor (a tensor map
//   made on the host by make_map_bf16) into shared memory, swizzled (with
//   128-byte rows the 16-byte chunk j of the box's row r lands at chunk
//   j ^ (r % 8)), which wgmma reads through a descriptor of the same swizzle
//   (mma_bf16.cuh: gmma_desc); the box completes on an mbarrier that counts
//   its bytes (expect_tx). Coordinates outside the tensor read as zero. One
//   copy should move a whole tile: a ring fed one 128-byte row per
//   cp.async.bulk ran several times slower. A TMA store writes a box back
//   from shared memory (clipped at the tensor's edges) in a bulk group;
//   cp.async.bulk of a contiguous byte range, on an mbarrier the same way;
//   cp.async of 4 or 8 bytes a thread, for rows whose stride fits no TMA box
//   (cp_async_arrive_noinc completes them on an mbarrier, cp_async_wait_all
//   waits for them in the issuing thread); of 4 or 16 bytes zero-filled
//   where out of range, in commit groups for a thread's double buffering;
//   mbarrier init, arrive and parity wait for full/empty rings; named
//   barriers for a subset of the block's warps.
// A ring slot used for the u-th time is waited on with parity u & 1: the wait
// returns once the barrier's phase u has completed.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async (per thread) ---------------------------------------------------

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 8 bytes (through L1); both addresses 8-byte aligned
__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 4 bytes (through L1), or 4 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async_4z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes (through L2 only), or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async_16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// this thread's cp.async since the last commit form a group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's groups but the newest N have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the mbarrier's pending count drops by one once all of this thread's
// cp.async so far have landed (count it in the barrier's init)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- mbarrier ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any other thread or the copy engine uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and have the phase also wait for `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A wait that has not ended after ~2^34 clocks (several seconds) traps: a
// copy that never lands fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---- TMA (one thread, completed on an mbarrier) -------------------------------

// byte offset of the 16-byte chunk j of row r in a 128-byte-swizzled tile of
// 128-byte rows (the tile 1024-byte aligned), as TMA writes it
__device__ __forceinline__ uint32_t swz128(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

// the box at element coordinates (c0 along rows, c1 across them) of `map`
// into dst (1024-byte aligned); rows past the tensor's end read as zero
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// fetch a tensor map (a __grid_constant__ parameter) ahead of its first copy
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// the box at (c0, c1, c2, c3) of `map` from src (1024-byte aligned), in this
// thread's current bulk group; parts outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups but the newest N have finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ... and finished writing global memory
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned, completed on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// this thread's writes to shared memory so far are ordered before later
// accesses by the async proxy (TMA loads that overwrite them, TMA stores that
// read them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers ----------------------------------------------------------------

// `threads` (a multiple of 32) of the block meet at barrier `id` (1..15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- host: tensor maps ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map of `rank` dims (dims[0] innermost, contiguous, 64
// elements: 128 bytes, the 128-byte swizzle's width), dim i + 1 strides[i]
// bytes apart (multiples of 16; base 16-byte aligned), in boxes of box[i]
// elements, 128-byte swizzled; elements outside the tensor read as zero.
inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int rank,
                                 const uint64_t* dims, const uint64_t* strides,
                                 const uint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], elem_strides[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    elem_strides[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), d, st, bx, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// `rows` rows of `inner` elements, `row_bytes` apart, in boxes of box_rows
// rows of 64 elements
inline cudaError_t make_map_2d_bf16(CUtensorMap* map, const void* base, uint64_t inner,
                                    uint64_t rows, uint64_t row_bytes, uint32_t box_rows) {
  const uint64_t dims[2] = {inner, rows};
  const uint32_t box[2] = {64, box_rows};
  return make_map_bf16(map, base, 2, dims, &row_bytes, box);
}

}  // namespace
