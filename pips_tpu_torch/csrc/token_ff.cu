// Fused MLP-Mixer token block, forward:
//   y = x + (gelu(LN(x)^T w1 + b1) w2 + b2)^T, mixing over the S tokens of each point.
//
// Replaces no TPU kernel: pips_tpu/models/mixer.py leaves the token half to
// XLA, which fuses its jnp ops. In the port it ran as ~32 PyTorch operations
// a block (models/mixer.py's LayerNorm and TokenMixFF, then the residual),
// each a round trip of the rows through HBM; a dense window runs 72 blocks.
// x is (P, S, D): P = B*N points of S = 8 tokens and D = 512 channels; w1
// (S, 4S), w2 (4S, S) and the f32 vectors as the modules store them (f32).
//
// What bounds it on an H100: x read once and y written once, 2*P*S*D
// elements (126 MB in bf16 at the dense window's P = 7,680: 0.038 ms at 3.35
// TB/s), against P*D*4S exact-erf GELUs (126 M there, ~28 instructions each
// with its bias: ~0.1 ms of the SMs' instruction slots) and 2*P*D*S*4S
// multiply-adds in the two token products (2.0 G). So the GELUs set the
// time, and in bf16 the products go to the tensor cores, leaving the FMA
// pipes to the GELUs.
//
// Design. A block takes one point: its S rows of D land in shared memory by
// cp.async, each row padded by 16 bytes so that the transposed fragment loads
// below meet every bank once; while they land, each thread loads its weight
// fragments. A warp a row takes the LN statistics. Then each warp walks
// 32-channel slices of the point: one ldmatrix.trans gives each lane x at two
// tokens of four channels, the very positions the lane holds in the first
// product's A fragment and in the second product's accumulator. For each 16
// channels (bf16, namespace tc): LN in f32 rounded to bf16 (the plain twin's
// .to(x.dtype)); the 8 -> 32 product on four mma.sync m16n8k8 (bf16 in, f32
// accumulate); b1 and GELU in f32 on the accumulators, rounded to bf16 into
// the second product's A fragment (the plain twin rounds them there too); the
// 32 -> 8 product on two m16n8k16; b2 and the residual in f32 and one
// rounding to bf16. The slice goes back over x's in shared memory
// (stmatrix.trans) and out in 16-byte stores, 8 rows of 64 bytes a warp. In
// f32 (namespace simt) a thread takes two channels of the point over all S
// tokens and runs both products on f32 FMAs, the weights broadcast from
// shared memory.
//
// Numerics (token_mix_reference's): LN statistics in f32 with
// var = E[x^2] - mu^2 clamped at 0, eps 1e-5, applied as
// (x - mu) * (rsig * scale) + bias; the weights rounded to x's dtype; the
// products accumulate in f32; exact-erf GELU in f32 (CUDA's erff, as
// PyTorch's GELU). In bf16 the plain twin also rounds each product, b1, b2
// and the sum before the residual to bf16; this kernel keeps them in f32 and
// rounds y once.
//
// Plain C ABI (loaded with ctypes): pips_token_ff returns cudaGetLastError()
// after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "chanff_rows.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kS = 8;    // tokens of a point
constexpr int kH = 32;   // hidden tokens: S * expansion 4
constexpr int kD = 512;  // channels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == kS, "a warp a token row for the statistics");

// (x - mu) * (rsig * scale) + bias, each operation rounded as PyTorch's are
__device__ __forceinline__ float ln(float v, float mu, float rsig, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mu), __fmul_rn(rsig, scale)), bias);
}

// the LN statistics of the point's row `warp` of the tile (rows `pitch`
// elements apart) into stats[0][warp] (mu) and stats[1][warp] (rsig)
template <typename T>
__device__ __forceinline__ void row_stats(const T* tile, int pitch, float (*stats)[kS]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* row = tile + warp * pitch;
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kD / 32; ++i) {
    const float v = to_f32(row[lane + 32 * i]);
    s += v;
    s2 += v * v;
  }
  float mu, rsig;
  warp_ln_stats<kD>(s, s2, mu, rsig);
  if (lane == 0) {
    stats[0][warp] = mu;
    stats[1][warp] = rsig;
  }
}

namespace tc {

constexpr int kPitch = kD + 8;  // a row's bf16 in shared memory: 16 bytes of padding

// d (16 x 8 f32) += a (16 x 8, row-major) * b (8 x 8, column-major), bf16 in
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
// a in the low half, b in the high half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));
}

// One point a block. Lane (g, t) = (lane / 4, lane % 4) holds tokens 2t and
// 2t + 1 of channels c0 + g and c0 + 8 + g of each 16-channel group c0: as
// the first product's A rows and K, the second product's rows and N.
__global__ void __launch_bounds__(kThreads)
token_ff_bf16(const bf16* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ y) {
  __shared__ __align__(16) bf16 tile[kS * kPitch];
  __shared__ float stats[2][kS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t0 = 2 * (lane % 4);
  const size_t base = (size_t)blockIdx.x * kS * kD;
#pragma unroll
  for (int c = tid; c < kS * kD / 8; c += kThreads)
    cp_async_16z(tile + (c / (kD / 8)) * kPitch + (c % (kD / 8)) * 8, x + base + 8 * c, true);
  cp_async_commit();

  // weight fragments in bf16 (the plain twin's .to(x.dtype)), biases in f32:
  // w1's n8 tile n holds hidden 8n + g at tokens t0, t0 + 1; w2's k16 step k
  // holds token g at hidden 16k + t0 + {0, 1} and 16k + 8 + t0 + {0, 1}
  uint32_t fw1[4], fw2[2][2];
  float fb1[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    fw1[n] = pack(w1[t0 * kH + 8 * n + g], w1[(t0 + 1) * kH + 8 * n + g]);
    fb1[n][0] = b1[8 * n + t0];
    fb1[n][1] = b1[8 * n + t0 + 1];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    fw2[k][0] = pack(w2[(16 * k + t0) * kS + g], w2[(16 * k + t0 + 1) * kS + g]);
    fw2[k][1] = pack(w2[(16 * k + 8 + t0) * kS + g], w2[(16 * k + 9 + t0) * kS + g]);
  }
  const float fb2[2] = {b2[t0], b2[t0 + 1]};

  cp_async_wait_all();
  __syncthreads();
  row_stats(tile, kPitch, stats);
  __syncthreads();
  const float mu[2] = {stats[0][t0], stats[0][t0 + 1]};
  const float rsig[2] = {stats[1][t0], stats[1][t0 + 1]};

  for (int c0 = 32 * warp; c0 < kD; c0 += 32 * kWarps) {
    // lane l addresses token l % 8 of the 8 channels c0 + 8 (l / 8): matrix
    // m of the four holds channels c0 + 8m, and gives this lane tokens t0,
    // t0 + 1 of channel c0 + 8m + g
    bf16* at = tile + (lane % 8) * kPitch + c0 + 8 * (lane / 8);
    uint32_t xr[4], xa[4], out[4];
    ldmatrix_x4_trans(xr[0], xr[1], xr[2], xr[3], at);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = c0 + 8 * m + g;
      const float sc = scale[c], bi = bias[c];
      xa[m] = pack(ln(lo(xr[m]), mu[0], rsig[0], sc, bi), ln(hi(xr[m]), mu[1], rsig[1], sc, bi));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // channels c0 + 16q: A rows g (matrix 2q), g + 8 (2q + 1)
      float h[4][4] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_k8(h[n], xa[2 * q], xa[2 * q + 1], fw1[n]);
      // n8 tile n is half n % 2 of the second product's k16 step n / 2
      uint32_t ga[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        ga[n / 2][2 * (n % 2)] = pack(gelu(h[n][0] + fb1[n][0]), gelu(h[n][1] + fb1[n][1]));
        ga[n / 2][2 * (n % 2) + 1] =
            pack(gelu(h[n][2] + fb1[n][0]), gelu(h[n][3] + fb1[n][1]));
      }
      float o[4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k) mma_bf16(o, ga[k], fw2[k][0], fw2[k][1]);
      out[2 * q] = pack(lo(xr[2 * q]) + (o[0] + fb2[0]), hi(xr[2 * q]) + (o[1] + fb2[1]));
      out[2 * q + 1] =
          pack(lo(xr[2 * q + 1]) + (o[2] + fb2[0]), hi(xr[2 * q + 1]) + (o[3] + fb2[1]));
    }
    stmatrix_x4_trans(at, out[0], out[1], out[2], out[3]);
    __syncwarp();
    // the slice, 8 rows of 64 bytes: lane l stores the 16 bytes it addressed
    *reinterpret_cast<uint4*>(y + base + (lane % 8) * kD + c0 + 8 * (lane / 8)) =
        *reinterpret_cast<const uint4*>(at);
  }
}

}  // namespace tc

namespace simt {

constexpr int kPitch = kD + 4;  // a row's floats in shared memory

// One point a block; thread t takes channels t and t + 256 over all S tokens.
__global__ void __launch_bounds__(kThreads)
token_ff_f32(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ y) {
  static_assert(kD == 2 * kThreads && kS * kH == kThreads, "two channels a thread, a weight each");
  __shared__ __align__(16) float tile[kS * kPitch];
  __shared__ __align__(16) float w1t[kH][kS];  // w1 transposed: hidden j's S weights
  __shared__ __align__(16) float w2s[kH][kS];
  __shared__ float b1s[kH];
  __shared__ float stats[2][kS];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kS * kD;
#pragma unroll
  for (int c = tid; c < kS * kD / 4; c += kThreads)
    cp_async_16z(tile + (c / (kD / 4)) * kPitch + (c % (kD / 4)) * 4, x + base + 4 * c, true);
  cp_async_commit();
  w1t[tid % kH][tid / kH] = w1[tid];
  w2s[tid / kS][tid % kS] = w2[tid];
  if (tid < kH) b1s[tid] = b1[tid];
  cp_async_wait_all();
  __syncthreads();
  row_stats(tile, kPitch, stats);
  __syncthreads();

  float xa[2][kS], o[2][kS];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = tid + kThreads * u;
    const float sc = scale[c], bi = bias[c];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      xa[u][s] = ln(tile[s * kPitch + c], stats[0][s], stats[1][s], sc, bi);
      o[u][s] = 0.0f;
    }
  }
#pragma unroll 4
  for (int j = 0; j < kH; ++j) {
    const float4 wa = *reinterpret_cast<const float4*>(&w1t[j][0]);
    const float4 wb = *reinterpret_cast<const float4*>(&w1t[j][4]);
    const float4 va = *reinterpret_cast<const float4*>(&w2s[j][0]);
    const float4 vb = *reinterpret_cast<const float4*>(&w2s[j][4]);
    const float wj[kS] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float vj[kS] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float a = 0.0f;
#pragma unroll
      for (int s = 0; s < kS; ++s) a = fmaf(xa[u][s], wj[s], a);
      const float gj = gelu(a + b1s[j]);
#pragma unroll
      for (int s = 0; s < kS; ++s) o[u][s] = fmaf(gj, vj[s], o[u][s]);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = tid + kThreads * u;
#pragma unroll
    for (int s = 0; s < kS; ++s) y[base + s * kD + c] = tile[s * kPitch + c] + (o[u][s] + b2[s]);
  }
}

}  // namespace simt

}  // namespace

extern "C" {

// Shapes the kernel takes: points >= 1, S == 8, H == 32 (expansion 4),
// D == 512. dtype_code 0 = float32, 1 = bfloat16 (x and y, (points, S, D)
// contiguous, 16-byte aligned); ln_scale, ln_bias (D), w1 (S, H), b1 (H), w2
// (H, S), b2 (S) are float32 and contiguous.
int pips_token_ff(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                  const void* b1, const void* w2, const void* b2, void* y, int points, int S,
                  int H, int D, int dtype_code, int device, void* stream) {
  if (points <= 0 || S != kS || H != kH || D != kD || (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(ln_scale);
  const float* bi = static_cast<const float*>(ln_bias);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fw2 = static_cast<const float*>(w2);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype_code == 1)
    tc::token_ff_bf16<<<points, kThreads, 0, s>>>(static_cast<const bf16*>(x), sc, bi, fw1, fb1,
                                                  fw2, fb2, static_cast<bf16*>(y));
  else
    simt::token_ff_f32<<<points, kThreads, 0, s>>>(static_cast<const float*>(x), sc, bi, fw1, fb1,
                                                   fw2, fb2, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

}  // extern "C"
