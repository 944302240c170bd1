// Fused correlation + patch sampling over a feature pyramid, forward only.
//
// Replaces the TPU kernel pips_tpu/kernels/corr_pallas.py:corr_sample_pallas
// (pallas_call of _corr_sample_kernel in corr_sample_pallas_level). For each
// point n of frame (b, s) and each pyramid level l, with c = coords / 2^l,
// x0 = floor(c_x), wx = c_x - x0 (and the same in y):
//   g[a][b]      = dot(target, fmap_l[y0 - 3 + a, x0 - 3 + b]) / sqrt(C),
//                  a, b in 0..7, zero for a pixel outside the map;
//   out[i*7 + j] = (1-wy)(1-wx) g[j][i] + (1-wy) wx g[j][i+1]
//                + wy (1-wx) g[j+1][i] + wy wx g[j+1][i+1]
// written as f32 into out[(b, s), n, l*49 + i*7 + j]. The (B, S, N, H_l, W_l)
// score volume is never formed.
//
// What bounds it on an H100: the patch form does 2*64*C operations per point
// and level (134 MFLOP at S=8, N=256, L=4, C=128: 0.14 us at 989 TFLOP/s)
// against the bytes of the output (L*49 f32 per point), the targets and the
// map pixels the patches touch, each read once: at most ~23 MB at N=256 and
// 480x1024 frames (6.9 us at 3.35 TB/s), fewer where the patches leave pixels
// untouched. It is bound by memory.
//
// Design. The TPU kernel computes the whole (TN, H*Wp) score tile with one MXU
// matmul and selects the patch with one-hot masks, because Mosaic rejects
// in-kernel gathers. Hopper gathers well, so this kernel reads only the patch:
// one warp per (frame, point, level); its lanes split C = 128, four channels
// each, and hold the target in registers. For each of the 64 integer
// pixels inside the map the warp reads the pixel's C values (256 contiguous
// bytes in bf16, one coalesced read), dots them with the target in f32 and
// reduces across lanes with __shfl_xor_sync; a row's 8 reads are issued before
// its reductions. The 64 scores go to shared memory, then each lane combines
// one or two of the 49 outputs and writes them straight into the level's slice
// of the concatenated output. Bounds are checked per pixel: no clamped reads,
// no padding. All levels run in one launch. Plain SIMT; vector width, TMA and
// L2-aware ordering of the points are later work.
//
// Numerics follow ops/corr.py:fused_corr_sample: products and sums in f32 (a
// bf16 product is exact in f32; with f32 targets against bf16 maps the map
// value is widened, never the target narrowed), no TF32, the scale applied to
// the sum. Only the order of the f32 sum differs.
//
// Plain C ABI (loaded with ctypes): pips_corr_sample_fwd returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLevels = 8;
constexpr int kC = 128;  // channels: 32 lanes x 4
constexpr int kRadius = 3;
constexpr int kG = 2 * kRadius + 2;  // integer patch side, 8
constexpr int kP = 2 * kRadius + 1;  // sampled patch side, 7
constexpr int kThreads = 256;        // 8 warps, one (frame, point, level) each
constexpr int kWarps = kThreads / 32;
constexpr float kCoordLimit = 1.0e8f;  // |coords| beyond this are off every map

struct Levels {
  const void* map[kMaxLevels];  // (B*S, H, W, C) contiguous
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// Four consecutive channels of a map pixel, widened to f32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// TM: map dtype; TT: target dtype.
template <typename TM, typename TT>
__global__ void __launch_bounds__(kThreads)
corr_sample_fwd(Levels lv, int L, const TT* __restrict__ targets, long long tsb,
                long long tss, long long tsn, const float* __restrict__ coords,
                long long csb, long long css, long long csn, float* __restrict__ out,
                int S, int N, long long n_work, float scale) {
  __shared__ float sg[kWarps][kG * kG];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= n_work) return;  // whole warp leaves together
  // work order: level slowest, then frame, then point, so that the warps of a
  // block read neighbouring points of one map
  const long long BSN = n_work / L;
  const int lvl = (int)(w / BSN);
  const long long bsn = w - (long long)lvl * BSN;
  const int n = (int)(bsn % N);
  const long long bs = bsn / N;
  const long long b = bs / S, s = bs % S;
  // select the level with constant indices: a runtime index into the
  // parameter struct would copy it to local memory
  const void* map = lv.map[0];
  int H = lv.H[0], W = lv.W[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)
    if (l == lvl) { map = lv.map[l]; H = lv.H[l]; W = lv.W[l]; }
  const TM* fm = static_cast<const TM*>(map) + bs * (long long)H * W * kC;

  const float* cp = coords + b * csb + s * css + n * csn;
  const float inv = 1.0f / (float)(1 << lvl);  // exact: a power of two
  const float cx = cp[0] * inv, cy = cp[1] * inv;
  const float x0f = floorf(cx), y0f = floorf(cy);
  const float wx = cx - x0f, wy = cy - y0f;
  // clamp before the int conversion; such a point has no tap inside any map
  const int x0 = (int)fminf(fmaxf(x0f, -kCoordLimit), kCoordLimit);
  const int y0 = (int)fminf(fmaxf(y0f, -kCoordLimit), kCoordLimit);

  float t[4];
  const TT* tp = targets + b * tsb + s * tss + n * tsn + lane * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) t[e] = to_f32(tp[e]);

#pragma unroll 1
  for (int a = 0; a < kG; ++a) {
    const int yy = y0 - kRadius + a;
    const bool row_in = yy >= 0 && yy < H;  // the same for every lane
    float part[kG];
#pragma unroll
    for (int c = 0; c < kG; ++c) {
      const int xx = x0 - kRadius + c;
      part[c] = 0.0f;
      if (row_in && xx >= 0 && xx < W) {
        float v[4];
        load4(fm + ((long long)yy * W + xx) * kC + lane * 4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c] = fmaf(v[e], t[e], part[c]);
      }
    }
    if (row_in) {
#pragma unroll
      for (int c = 0; c < kG; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kG; ++c) sg[warp][a * kG + c] = part[c] * scale;
    }
  }
  __syncwarp();

  const float w00 = (1.0f - wy) * (1.0f - wx), w01 = (1.0f - wy) * wx;
  const float w10 = wy * (1.0f - wx), w11 = wy * wx;
  float* op = out + bsn * (long long)(L * kP * kP) + lvl * kP * kP;
  for (int o = lane; o < kP * kP; o += 32) {
    const int i = o / kP, j = o % kP;
    const float* g = sg[warp];
    op[o] = w00 * g[j * kG + i] + w01 * g[j * kG + i + 1] + w10 * g[(j + 1) * kG + i] +
            w11 * g[(j + 1) * kG + i + 1];
  }
}

template <typename TM, typename TT>
cudaError_t launch(dim3 grid, cudaStream_t st, const Levels& lv, int L, const void* targets,
                   const long long* ts, const float* coords, const long long* cs, float* out,
                   int S, int N, long long n_work, float scale) {
  corr_sample_fwd<TM, TT><<<grid, kThreads, 0, st>>>(
      lv, L, static_cast<const TT*>(targets), ts[0], ts[1], ts[2], coords, cs[0], cs[1], cs[2],
      out, S, N, n_work, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// maps: L device pointers, each (B*S, H[l], W[l], C) contiguous and 16-byte
// aligned; targets (B, S, N, C) with element strides tstrides[3] for b, s, n and
// unit stride over C; coords (B, S, N, 2) f32 at level-0 scale with strides
// cstrides[3] and unit stride over xy; out (B*S*N, L*49) f32 contiguous.
// C = 128; radius 3. dtype codes: 0 = float32,
// 1 = bfloat16; (map, target) must be (1, 1), (1, 0) or (0, 0).
int pips_corr_sample_fwd(const void* const* maps, const int* hs, const int* ws, int L,
                         const void* targets, const long long* tstrides,
                         const void* coords, const long long* cstrides, void* out,
                         int B, int S, int N, int C, int map_dtype, int tgt_dtype,
                         float scale, int device, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || S < 1 || N < 1 || C != kC ||
      (map_dtype == 0 && tgt_dtype != 0) || map_dtype < 0 || map_dtype > 1 || tgt_dtype < 0 ||
      tgt_dtype > 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    lv.map[l] = maps[l];
    lv.H[l] = hs[l];
    lv.W[l] = ws[l];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_work = (long long)B * S * N * L;
  const dim3 grid((unsigned)((n_work + kWarps - 1) / kWarps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(coords);
  float* op = static_cast<float*>(out);
  if (map_dtype == 1 && tgt_dtype == 1)
    return (int)launch<bf16, bf16>(grid, st, lv, L, targets, tstrides, cp, cstrides, op, S, N,
                                   n_work, scale);
  if (map_dtype == 1)
    return (int)launch<bf16, float>(grid, st, lv, L, targets, tstrides, cp, cstrides, op, S, N,
                                    n_work, scale);
  return (int)launch<float, float>(grid, st, lv, L, targets, tstrides, cp, cstrides, op, S, N,
                                   n_work, scale);
}

}  // extern "C"
