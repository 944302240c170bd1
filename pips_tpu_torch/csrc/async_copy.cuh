// Asynchronous copies into shared memory and the mbarriers that track them
// (sm_90), shared by the pipelined kernels (stem_wgrad.cu, mixer_probes.cu):
//   TMA: one thread copies a 2D box of a bf16 tensor (a tensor map made on
//   the host by make_map_2d_bf16) into shared memory, swizzled (with
//   128-byte rows the 16-byte chunk j of the box's row r lands at chunk
//   j ^ (r % 8)), which wgmma reads through a descriptor of the same swizzle
//   (mma_bf16.cuh: gmma_desc); the box completes on an mbarrier that counts
//   its bytes (expect_tx). One copy should move a whole tile: a ring fed one
//   128-byte row per cp.async.bulk ran several times slower;
//   cp.async of 4 bytes a thread, for rows whose stride is no multiple of 16
//   bytes (no TMA box fits them), completed on the same mbarrier
//   (cp_async_arrive_noinc);
//   mbarrier init, arrive and parity wait for full/empty rings.
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

// ---- host: tensor maps ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map of `rows` rows of `inner` elements, `row_bytes` apart (a
// multiple of 16; base 16-byte aligned), in boxes of box_rows rows of 64
// elements (128 bytes: the 128-byte swizzle's width).
inline cudaError_t make_map_2d_bf16(CUtensorMap* map, const void* base, uint64_t inner,
                                    uint64_t rows, uint64_t row_bytes, uint32_t box_rows) {
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
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
