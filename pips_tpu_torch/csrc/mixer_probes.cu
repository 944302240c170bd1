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
// they take a few microseconds, near the cost of a launch.
//
// Design (plain; these are probes). gelu: a grid-stride loop over eight
// values a thread (16-byte loads and stores), GELU as chanff_rows.cuh writes
// it, a * Phi(a), within an f32 ulp of the probe's 0.5 a (1 + erf(a / sqrt 2))
// before the one rounding to bf16. ln_slice: one warp per row, two passes over
// the row's D lanes (the second from L1), the input's row stride given.
// stream_accum: the TPU's sequential grid over weight blocks becomes a loop
// inside the block. One block owns 16 output columns of 128 rows (N = 2048
// gives 128 blocks, one wave) and keeps x[rows, 0:512] in shared memory
// (133 KB, loaded once): the product is one GEMM with K = 12 * 512 whose A
// operand repeats every 512. Each weight block's (512, 16) slice of w1 is
// staged in shared memory (k-major, read by ldmatrix.trans) while the next
// one is loaded into registers; each of 8 warps owns 16 rows x 16 columns on
// mma.sync m16n8k16 with f32 accumulators and writes them once, so there are
// no atomics and no second pass.
//
// Plain C ABI (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kBM = kWarps * 16;      // 128 rows a block, 16 a warp
constexpr int kBN = 16;               // columns a block: two n8 tiles
constexpr int kLdA = kK + 8;          // bf16 row stride of the x stage (conflict-free ldmatrix)
constexpr int kLdB = kBN + 8;         // bf16 row stride of the w1 stage
constexpr int kBVecs = kK * kBN / 8;  // 16-byte vectors of one w1 slice: 1024
constexpr int kBPer = kBVecs / kThreads;  // 4 a thread
constexpr size_t kABytes = (size_t)kBM * kLdA * 2;  // 133,120
constexpr size_t kSmem = kABytes + (size_t)kK * kLdB * 2;  // + 24,576
static_assert(kBVecs % kThreads == 0, "w1 slice vectors per thread");
static_assert(kABytes % 16 == 0, "w1 stage alignment");

// o (M, N) f32 = sum_{b < NB} x[:, 0:kK] @ w[b]; x (M, >= kK) bf16 at row
// stride ldx, w (NB, kK, N) bf16 contiguous. Grid (N / kBN, ceil(M / kBM)).
__global__ void __launch_bounds__(kThreads) probe_stream_accum(const bf16* __restrict__ x,
                                                               const bf16* __restrict__ w,
                                                               float* __restrict__ o, int M,
                                                               int N, int NB, int ldx) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + kABytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN, m_base = blockIdx.y * kBM;

  // x[rows, 0:kK] once, zero past M
  for (int i = tid; i < kBM * kK / 8; i += kThreads) {
    const int r = i / (kK / 8), c = (i % (kK / 8)) * 8;
    const int row = m_base + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < M) v = *reinterpret_cast<const uint4*>(x + (size_t)row * ldx + c);
    *reinterpret_cast<uint4*>(As + r * kLdA + c) = v;
  }
  // vector i of a slice is row i / 2, columns n0 + (i % 2) * 8 .. + 7
  uint4 next[kBPer];
  auto load_b = [&](int b) {
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kThreads;
      next[j] = *reinterpret_cast<const uint4*>(w + ((size_t)b * kK + i / 2) * N + n0 +
                                                (i % 2) * 8);
    }
  };
  auto store_b = [&]() {
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(Bs + (i / 2) * kLdB + (i % 2) * 8) = next[j];
    }
  };
  load_b(0);
  store_b();
  __syncthreads();

  const int m0 = warp * 16;
  const bool active = m_base + m0 < M;
  // this lane's ldmatrix row: of A, row m0 + lane % 16, 8-column half lane / 16;
  // of each 16-row k-step of B, row lane % 8 + 8 * ((lane / 8) & 1), half lane / 16
  const bf16* a_frag = As + (m0 + lane % 16) * kLdA + (lane / 16) * 8;
  const bf16* b_frag = Bs + (lane % 8 + 8 * ((lane / 8) & 1)) * kLdB + 8 * (lane / 16);
  float acc[2][4] = {};
  for (int b = 0; b < NB; ++b) {
    if (b + 1 < NB) load_b(b + 1);
    if (active) {
#pragma unroll 4
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t a[4], b00, b01, b10, b11;
        ldmatrix_x4(a[0], a[1], a[2], a[3], a_frag + ks * 16);
        ldmatrix_x4_trans(b00, b01, b10, b11, b_frag + ks * 16 * kLdB);
        mma_bf16(acc[0], a, b00, b01);
        mma_bf16(acc[1], a, b10, b11);
      }
    }
    __syncthreads();
    if (b + 1 < NB) {
      store_b();
      __syncthreads();
    }
  }
  if (!active) return;
  const int r0 = m_base + m0 + lane / 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float* dst = o + (size_t)r0 * N + n0 + 8 * t + 2 * (lane % 4);
    if (r0 < M) *reinterpret_cast<float2*>(dst) = make_float2(acc[t][0], acc[t][1]);
    if (r0 + 8 < M)
      *reinterpret_cast<float2*>(dst + (size_t)8 * N) = make_float2(acc[t][2], acc[t][3]);
  }
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
// contiguous, N a multiple of 16; o (M, N) f32 contiguous; all 16-byte aligned.
int pips_probe_stream_accum(const void* x, const void* w, void* o, int M, int N, int NB,
                            int ldx, int device, void* stream) {
  if (M <= 0 || N <= 0 || N % kBN || NB <= 0 || ldx < kK || ldx % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(probe_stream_accum, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  probe_stream_accum<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(o), M, N, NB,
      ldx);
  return (int)cudaGetLastError();
}

}  // extern "C"
