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
// f32 output). A few microseconds with the launches: a launch's cost.
//
// Design (plain). The rows are cut into the splits the caller asks for (the
// wrapper: one per 64 rows), of equal length. One block per (batch, split)
// keeps one f32 sum per output (threads stride over the CA * CB outputs;
// neighbouring threads read neighbouring b lanes, each a value is a
// broadcast) and writes its partials. With more than one split a second
// launch adds the splits' partials in split order, so the result is
// deterministic without atomics; with one split the first launch writes the
// output itself.
//
// Plain C ABI (loaded with ctypes): pips_row_contract returns
// cudaGetLastError() after its launches; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// grid (G, splits); part (splits, G, CA, CB) f32
__global__ void __launch_bounds__(kThreads) row_contract_partial(
    const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ part, int G,
    int R, int CA, int CB, int a_bs, int a_rs, int b_bs, int b_rs, int rows_per) {
  const int g = blockIdx.x, split = blockIdx.y;
  const int i0 = split * rows_per;
  const int i1 = min(R, i0 + rows_per);
  const bf16* ag = a + (size_t)g * a_bs;
  const bf16* bg = b + (size_t)g * b_bs;
  float* p = part + ((size_t)split * G + g) * CA * CB;
  for (int j = threadIdx.x; j < CA * CB; j += kThreads) {
    const bf16* ac = ag + j / CB;  // a's lane c
    const bf16* bo = bg + j % CB;  // b's lane o
    float acc = 0.0f;
    for (int i = i0; i < i1; ++i)
      acc = fmaf(__bfloat162float(ac[(size_t)i * a_rs]), __bfloat162float(bo[(size_t)i * b_rs]),
                 acc);
    p[j] = acc;
  }
}

// out[j] = sum over splits, in order, of part[split, j]; n = G * CA * CB
__global__ void __launch_bounds__(kThreads) row_contract_sum(const float* __restrict__ part,
                                                             float* __restrict__ out, int n,
                                                             int splits) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += part[(size_t)s * n + j];
  out[j] = v;
}

}  // namespace

extern "C" {

// a, b: bf16 with the element strides given (the lane stride 1); out
// (G, CA, CB) float32 contiguous; part (splits, G, CA, CB) float32 scratch,
// unused (may be null) when splits == 1. Offsets must fit in 32 bits.
int pips_row_contract(const void* a, const void* b, void* out, void* part, int G, int R, int CA,
                      int CB, int a_bs, int a_rs, int b_bs, int b_rs, int splits, int device,
                      void* stream) {
  if (G <= 0 || R <= 0 || CA <= 0 || CB <= 0 || splits <= 0 || splits > R ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per = (R + splits - 1) / splits;
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(part);
  row_contract_partial<<<dim3(G, splits), kThreads, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), dst, G, R, CA, CB, a_bs, a_rs,
      b_bs, b_rs, rows_per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = G * CA * CB;
  row_contract_sum<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
