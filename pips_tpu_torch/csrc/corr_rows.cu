// The integer correlation patch of tools/debug_pallas7.py, which checked that
// Mosaic lowers a 3-D broadcast-multiply and axis reduction (the pallas_call
// at :15, body k_rows :33). For each frame s and point n, with
// x0 = floor(coords[s, n, 0]), y0 = floor(coords[s, n, 1]), G = 2r + 2 and
// P = 2r + 1, entry k = b * G + a of the output, for k < P * P, is
//   out[s, n, k] = sum_c targets[s, n, c] * fmap[s, (y0 - r + a) * W + (x0 - r + b), c],
// zero where that row or column lies outside the H x W map. The order is
// x-major, and only the first P * P of the G x G window are kept (at r = 3:
// b = 0..5 whole, then b = 6, a = 0). No bilinear weights, no scale. f32 in,
// f32 out, f32 products and sums (no TF32).
//
// What bounds it on an H100: the bytes of the map rows the patches touch,
// each read once (at most 49 rows of 128 f32 a point: 0.2 MB at the probe's
// 8 points, 0.06 us at 3.35 TB/s), against 2 * 49 * C operations a point. It
// is a few microseconds of work at most: a launch's cost.
//
// Design. The TPU kernel forms the whole (TN, H * W) score tile with one MXU
// matmul and selects the patch with one-hot masks; this kernel gathers only
// the patch. One warp per output (s, n, k): its lanes stride over C, read the
// map pixel's row (coalesced) and the target, sum the products in f32 and
// reduce across lanes with __shfl_xor_sync. A warp whose pixel is off the map
// writes zero and reads nothing. Coordinates whose magnitude is not below
// 1e8 (NaN included) count as off every map.
//
// Plain C ABI (loaded with ctypes): pips_corr_rows returns cudaGetLastError()
// after the launch; 0 means launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kCoordLimit = 1.0e8f;

// fmap (S, H * W, C), targets (S, N, C), coords (S, N, 2), out (S, N, P * P);
// all f32, contiguous.
__global__ void __launch_bounds__(kThreads) corr_rows(const float* __restrict__ fmap,
                                                      const float* __restrict__ targets,
                                                      const float* __restrict__ coords,
                                                      float* __restrict__ out, int S, int N, int H,
                                                      int W, int C, int r) {
  const int G = 2 * r + 2, PP = (2 * r + 1) * (2 * r + 1);
  const long g = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (g >= (long)S * N * PP) return;
  const int k = (int)(g % PP);
  const long sn = g / PP;
  const int s = (int)(sn / N);
  const float cx = coords[2 * sn], cy = coords[2 * sn + 1];
  float acc = 0.0f;
  if (fabsf(cx) < kCoordLimit && fabsf(cy) < kCoordLimit) {
    const int xx = (int)floorf(cx) - r + k / G, yy = (int)floorf(cy) - r + k % G;
    if (xx >= 0 && xx < W && yy >= 0 && yy < H) {
      const float* row = fmap + ((size_t)s * H * W + (size_t)yy * W + xx) * C;
      const float* t = targets + (size_t)sn * C;
      for (int c = lane; c < C; c += 32) acc = fmaf(t[c], row[c], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
  }
  if (lane == 0) out[g] = acc;
}

}  // namespace

extern "C" {

// Shapes: fmap (S, H * W, C), targets (S, N, C), coords (S, N, 2) and out
// (S, N, (2r + 1)^2), all float32 and contiguous; r >= 0.
int pips_corr_rows(const void* fmap, const void* targets, const void* coords, void* out, int S,
                   int N, int H, int W, int C, int r, int device, void* stream) {
  if (S <= 0 || N <= 0 || H <= 0 || W <= 0 || C <= 0 || r < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long warps = (long)S * N * (2 * r + 1) * (2 * r + 1);
  corr_rows<<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fmap), static_cast<const float*>(targets),
      static_cast<const float*>(coords), static_cast<float*>(out), S, N, H, W, C, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
