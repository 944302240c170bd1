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
// untouched. It is bound by memory. Each (point, level) item reads its 64
// patch pixels (16 KB in bf16) whatever its neighbours read: where patches
// overlap (the dense probe: N=7680 points on a 60x128 map share each level-0
// pixel about 64 ways) the second and later reads come from L2 or L1, and
// their rate, not the device memory's, sets the pace.
//
// Design. The TPU kernel computes the whole (TN, H*Wp) score tile with one MXU
// matmul and selects the patch with one-hot masks, because Mosaic rejects
// in-kernel gathers. Hopper gathers well, so this kernel reads only the patch,
// in one launch for all levels, by 16-byte loads that read whole 128-byte
// lines, bounds checked per pixel (no clamped reads, no padding). A warp
// takes a (frame, point) and lpw of its levels in turn (the wrapper's plan:
// all of them where points are many, so that the point's coords and target
// are loaded once and its L*49 outputs written together; fewer where that
// leaves the card idle). A dot is never reduced across a warp's 32 lanes,
// which took 320 shuffles an item and most of a launch at N=7680:
//   * bf16 maps and targets (scores_mma): the 64 scores are eight m16n8k16
//     products on the tensor cores (mma.sync, bf16 in, f32 accumulators: a
//     bf16 product is exact in f32, the sums are f32, no TF32), a patch row
//     each, whose rows are half-pixels (a pixel's 16-byte chunks of one
//     parity) and whose B columns are the target's halves; channels take the
//     same k order in A and B (the dot is the same in any one order). A
//     pixel's score is its two halves' sums: one shuffle, 16 an item.
//   * bf16 maps with f32 targets (the first iteration of a bf16 window): the
//     same products, the target split exactly into three bf16 parts
//     (TargetMma3), 48 products a level against 32.
//   * f32 maps (scores_simt): a half-warp a pixel, lane j holding eight
//     channels of the target; each lane sums its pixels' partial dots, then
//     reduce-scatters over the half-warp's 16 lanes leave lane j the scores
//     of two pixels: 30 shuffles an item.
// The 64 scores go to shared memory, then each lane combines one or two of
// the 49 outputs and writes them into the level's slice of the output.
// Cutting each map into cells, a block a cell that lists its points by a
// scan of the frame's, so that L1 keeps the cell's region between them,
// measured slower at N=256 and at N=7680 (PERF.md): the scan and the list
// cost more than the reuse gave.
//
// Numerics follow ops/corr.py:fused_corr_sample: products and sums in f32 (a
// bf16 product is exact in f32; with f32 targets against bf16 maps the map
// value is widened and the target split into parts whose sum is the target,
// never narrowed; each part's product with a bf16 value is exact), no TF32,
// the scale applied to the sum. Only the order of the f32 sum differs: the
// split adds the two small parts' products, at most 2^-8 and 2^-16 of the
// first's, before it. (A target below 2^-110 in magnitude, whose last part
// falls under bf16's normal range, is the one exception.)
//
// Plain C ABI (loaded with ctypes): pips_corr_sample_fwd returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLevels = 8;
constexpr int kC = 128;  // channels
constexpr int kRadius = 3;
constexpr int kG = 2 * kRadius + 2;  // integer patch side, 8
constexpr int kP = 2 * kRadius + 1;  // sampled patch side, 7
constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kCoordLimit = 1.0e8f;  // |coords| beyond this are off every map
constexpr int kBlocksPerSM = 4;        // 64 registers a thread

struct Levels {
  const void* map[kMaxLevels];  // (B*S, H, W, C) contiguous
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// One item: the patch's first pixel (x0 - 3, y0 - 3) on the frame's map and
// the bilinear weights.
struct Item {
  int px, py;
  float wx, wy;
};

// Scores [a * 8 + b] (scaled) into the 49 outputs: each lane writes
// outputs lane and lane + 32.
__device__ __forceinline__ void combine(const float* g, const Item& it, float* out, int lane) {
  const float w00 = (1.0f - it.wy) * (1.0f - it.wx), w01 = (1.0f - it.wy) * it.wx;
  const float w10 = it.wy * (1.0f - it.wx), w11 = it.wy * it.wx;
  for (int o = lane; o < kP * kP; o += 32) {
    const int i = o / kP, j = o % kP;
    out[o] = w00 * g[j * kG + i] + w01 * g[j * kG + i + 1] + w10 * g[(j + 1) * kG + i] +
             w11 * g[(j + 1) * kG + i + 1];
  }
}

// The frame's map, where its items' patches are read. Offsets are bytes from
// the frame's first pixel, in 32 bits (the C entry checks that a frame's map
// fits), and are formed only for rows and columns on the map, so that a
// point at +-1e8 forms none.
struct Map {
  const unsigned char* base;  // the frame's (H, W, C) map
  int H, W;
  // patch column c of item it: its offset, and whether it is on the map
  __device__ __forceinline__ int col(const Item& it, int c, int pixel_bytes, bool& ok) const {
    const int x = it.px + c;
    ok = x >= 0 && x < W;
    return ok ? x * pixel_bytes : 0;
  }
  // patch row a of item it: its offset, and whether it is on the map
  __device__ __forceinline__ int row(const Item& it, int a, int pixel_bytes, bool& ok) const {
    const int y = it.py + a;
    ok = y >= 0 && y < H;
    return ok ? y * W * pixel_bytes : 0;
  }
  // 16 bytes at `off`, or zeros off the map; read-only, through L1
  __device__ __forceinline__ uint4 ld(int off, bool ok) const {
    return ok ? __ldg(reinterpret_cast<const uint4*>(base + off)) : make_uint4(0u, 0u, 0u, 0u);
  }
};

// ------------------------------------------------ bf16 maps and targets (mma)
// The target, kept in shared memory as kWords 16-byte words a lane
// (word w of lane l at st[w * 32 + l]: a warp's read of a word is
// conflict-free), not in registers, which the patch's loads need more.
// bf16 maps and targets: this lane's two 16-byte chunks of the target (B).
struct TargetMma {
  static constexpr int kParts = 1, kWords = 2;
  __device__ __forceinline__ static void load(const bf16* tp, int lane, uint4* st) {
    const int t = lane & 3, h = (lane >> 2) & 1;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      st[u * 32 + lane] = __ldg(reinterpret_cast<const uint4*>(tp) + 2 * (4 * u + t) + h);
  }
};

// An item's 64 scores on the tensor cores, into g (lane 8 p + 4 h + t's view):
// the products' rows are half-pixels. Patch row a is one m16n8k16 product
// chain: row r (0..15) is patch pixel (a, (r % 8) / 2 + 4 (r / 8)) restricted
// to its 16-byte chunks of parity r % 2 (channels 16 i + 8 (r % 2) .. + 7),
// and B's column n is the target restricted to chunks of parity n % 2. Lane
// (g, t) = (lane / 4, lane % 4) holds chunk 2 (4 u + t) + g % 2 (u = 0, 1) of
// its two rows' pixels and of the target, one 16-byte load each: registers
// x, y are k-step 2 u (k = 2 t, 2 t + 1 and 2 t + 8, 2 t + 9), z, w k-step
// 2 u + 1, in A and B alike. So the eight lanes of a pixel read one 128-byte
// line a load, four pixels a warp. A pixel's dot is its even half's column 0
// plus its odd half's column 1: lane 8 p's accumulator 0 (or 2) plus lane
// 8 p + 4's accumulator 1 (or 3).
template <int kParts>
__device__ __forceinline__ void scores_mma(const Map& m, const Item& it, const uint4* st,
                                           float scale, float* g, int lane) {
  const int gq = lane >> 2, t = lane & 3, h = gq & 1, p = gq >> 1;
  // chunks 2 t + h and 8 + 2 t + h (16 and 144 bytes on) of columns p and p + 4
  bool okl, okh;
  const int cl = m.col(it, p, 2 * kC, okl) + 16 * (2 * t + h);
  const int ch = m.col(it, p + 4, 2 * kC, okh) + 16 * (2 * t + h);
#pragma unroll
  for (int a = 0; a < kG; ++a) {
    // (pixel p, u = 0), (p, 1), (p + 4, 0), (p + 4, 1): four 16-byte loads in flight
    bool oky;
    const int ro = m.row(it, a, 2 * kC, oky);
    const uint4 lo0 = m.ld(ro + cl, oky && okl), lo1 = m.ld(ro + cl + 128, oky && okl);
    const uint4 hi0 = m.ld(ro + ch, oky && okh), hi1 = m.ld(ro + ch + 128, oky && okh);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint32_t a0[4] = {lo0.x, hi0.x, lo0.y, hi0.y}, a1[4] = {lo0.z, hi0.z, lo0.w, hi0.w};
    const uint32_t a2[4] = {lo1.x, hi1.x, lo1.y, hi1.y}, a3[4] = {lo1.z, hi1.z, lo1.w, hi1.w};
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      const uint4 b0 = st[2 * k * 32 + lane], b1 = st[(2 * k + 1) * 32 + lane];
      mma_bf16(acc, a0, b0.x, b0.y);
      mma_bf16(acc, a1, b0.z, b0.w);
      mma_bf16(acc, a2, b1.x, b1.y);
      mma_bf16(acc, a3, b1.z, b1.w);
    }
    const float d0 = acc[0] + __shfl_xor_sync(0xffffffffu, acc[1], 4);
    const float d1 = acc[2] + __shfl_xor_sync(0xffffffffu, acc[3], 4);
    if ((lane & 7) == 0) {
      g[a * kG + p] = d0 * scale;
      g[a * kG + p + 4] = d1 * scale;
    }
  }
}

// bf16 maps with f32 targets: the target split exactly into three bf16
// parts, t = t1 + t2 + t3 (t1 = bf16(t), t2 = bf16(t - t1), t3 = t - t1 -
// t2: each difference is exact, and t3 needs at most 8 significant bits),
// this lane's two 16-byte chunks of each; the products take the parts
// smallest first.
struct TargetMma3 {
  static constexpr int kParts = 3, kWords = 6;
  __device__ __forceinline__ static void load(const float* tp, int lane, uint4* st) {
    const int t = lane & 3, h = (lane >> 2) & 1;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4* q = reinterpret_cast<const float4*>(tp + 8 * (2 * (4 * u + t) + h));
      const float4 lo = __ldg(q), hi = __ldg(q + 1);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t w[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r0 = v[2 * e], r1 = v[2 * e + 1];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const __nv_bfloat162 part = __floats2bfloat162_rn(r0, r1);
          w[2 - k][e] = bits(part);
          const float2 f = __bfloat1622float2(part);
          r0 -= f.x;
          r1 -= f.y;
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        st[(2 * k + u) * 32 + lane] = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
    }
  }
};

// --------------------------------------------- f32 maps (SIMT, reduce-scatter)
// This lane's eight channels of the target: 4 j .. 4 j + 3 and 64 + 4 j ..
// 64 + 4 j + 3, j = lane % 16.
struct TargetSimt {
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void load(const float* tp, int lane, uint4* st) {
    const int j = lane & 15;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      st[k * 32 + lane] = __ldg(reinterpret_cast<const uint4*>(tp + 64 * k + 4 * j));
  }
};

// An item's 64 scores by f32 FMAs: half-warp hh = lane / 16 takes pixels
// 2 q + hh (q = 0 .. 31; patch pixel p is row p / 8, column p % 8), lane
// j = lane % 16 its eight channels (16 bytes at 16 j and at 256 + 16 j of the
// pixel), so that a load of the half-warp reads two whole 128-byte lines.
// Each lane sums its pixels' partial dots, sixteen q (four patch rows) at a
// time, a row's eight 16-byte loads in flight; a reduce-scatter over the
// half-warp (8 + 4 + 2 + 1 shuffles, each step keeping the half of the
// values the lane's bit selects and adding the partner's copy of it) leaves
// lane j the sum of the sixteen's j-th: 30 shuffles an item.
__device__ __forceinline__ void scores_simt(const Map& m, const Item& it, const uint4* st,
                                            float scale, float* g, int lane) {
  constexpr int kPix = kC * 4;
  const int hh = lane >> 4, j = lane & 15;
  // columns 2 r + hh (r = 0 .. 3) of the patch, 16 j bytes on
  bool okc[4];
  int co[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) co[r] = m.col(it, 2 * r + hh, kPix, okc[r]) + 16 * j;
#pragma unroll
  for (int a0 = 0; a0 < kG; a0 += 4) {
    float v[16];  // v[i]: this lane's partial dot of pixel 2 (4 a0 + i) + hh
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bool oky;
      const int ro = m.row(it, a0 + a, kPix, oky);
      uint4 w[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = ro + co[r];
        const bool ok = oky && okc[r];
        w[r][0] = m.ld(o, ok);
        w[r][1] = m.ld(o + 256, ok);
      }
      const uint4 t0 = st[lane], t1 = st[32 + lane];
      const float tv[8] = {__uint_as_float(t0.x), __uint_as_float(t0.y), __uint_as_float(t0.z),
                           __uint_as_float(t0.w), __uint_as_float(t1.x), __uint_as_float(t1.y),
                           __uint_as_float(t1.z), __uint_as_float(t1.w)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t u[8] = {w[r][0].x, w[r][0].y, w[r][0].z, w[r][0].w,
                               w[r][1].x, w[r][1].y, w[r][1].z, w[r][1].w};
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(__uint_as_float(u[e]), tv[e], d);
        v[4 * a + r] = d;
      }
    }
    // the reduce-scatter: lane j ends with the sum of i = j
#pragma unroll
    for (int half = 8; half >= 1; half /= 2) {
      const bool upper = j & half;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float keep = upper ? v[i + half] : v[i], give = upper ? v[i] : v[i + half];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, half);
      }
    }
    g[2 * (4 * a0 + j) + hh] = v[0] * scale;
  }
}

// The target registers of a (TM, TT) kernel: bf16 maps take the tensor
// cores, f32 maps SIMT.
template <typename TM, typename TT>
using Target = typename std::conditional<
    sizeof(TM) == 2, typename std::conditional<sizeof(TT) == 2, TargetMma, TargetMma3>::type,
    TargetSimt>::type;

// One point's work at one level, by the whole warp: (cx, cy) its coords
// (level-0 scale; inv takes them to the level's), st its target's words in
// shared memory, o its 49 outputs.
template <typename TM, typename TT>
__device__ __forceinline__ void point(const Map& m, float cx, float cy, float inv,
                                      const uint4* st, float* o, float scale, float* g,
                                      int lane) {
  const float fx = cx * inv, fy = cy * inv;
  Item it;
  // clamp before the int conversion; such a point has no tap inside any map
  it.px = (int)fminf(fmaxf(floorf(fx), -kCoordLimit), kCoordLimit) - kRadius;
  it.py = (int)fminf(fmaxf(floorf(fy), -kCoordLimit), kCoordLimit) - kRadius;
  if constexpr (sizeof(TM) == 2)
    scores_mma<Target<TM, TT>::kParts>(m, it, st, scale, g, lane);
  else
    scores_simt(m, it, st, scale, g, lane);
  // the weights after the scores, which then hold two registers fewer
  it.wx = fx - floorf(fx);
  it.wy = fy - floorf(fy);
  __syncwarp();
  combine(g, it, o, lane);
  __syncwarp();  // the scores are read before the warp's next point writes them
}


// Blocks an SM (the launch bounds): kBlocksPerSM with bf16 maps (64
// registers a thread), three (80) with f32 maps, whose sixteen partial dots
// and a row's eight loads in flight need more.
#define PIPS_CORR_BLOCKS(TM, TT) (sizeof(TM) == 2 ? kBlocksPerSM : 3)

// TM: map dtype, TT: target dtype (bf16 and bf16: the tensor cores; f32
// targets: SIMT). Block (x, y, z) takes points 8 x .. 8 x + 7 of frame y, one
// a warp, which loads the point's coords and target once and takes levels
// lpw z .. lpw z + lpw - 1 (those below L) in turn.
template <typename TM, typename TT>
__global__ void __launch_bounds__(kThreads, PIPS_CORR_BLOCKS(TM, TT))
corr_sample_points(Levels lv, int L, int lpw, const TT* __restrict__ targets, long long tsb,
                   long long tss, long long tsn, const float* __restrict__ coords,
                   long long csb, long long css, long long csn, float* __restrict__ out, int S,
                   int N, float scale) {
  using T = Target<TM, TT>;
  __shared__ float sg[kWarps][kG * kG];
  __shared__ uint4 stg[kWarps][T::kWords * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;  // whole warp leaves together
  const int bs = blockIdx.y, b = bs / S, s = bs % S;
  const float* c = coords + b * csb + s * css + n * csn;
  const float cx = c[0], cy = c[1];
  T::load(targets + b * tsb + s * tss + n * tsn, lane, stg[warp]);
  __syncwarp();
  float* o = out + ((long long)bs * N + n) * (L * kP * kP);
  const int l0 = blockIdx.z * lpw, l1 = min(L, l0 + lpw);
#pragma unroll 1
  for (int lvl = l0; lvl < l1; ++lvl) {
    // the level's map, selected with constant indices: a runtime index into
    // the parameter struct would copy it to local memory
    Map m;
    const void* map = lv.map[0];
    m.H = lv.H[0];
    m.W = lv.W[0];
#pragma unroll
    for (int l = 1; l < kMaxLevels; ++l)
      if (l == lvl) {
        map = lv.map[l];
        m.H = lv.H[l];
        m.W = lv.W[l];
      }
    m.base = static_cast<const unsigned char*>(map) +
             (long long)bs * m.H * m.W * kC * (long long)sizeof(TM);
    point<TM, TT>(m, cx, cy, 1.0f / (float)(1 << lvl), stg[warp], o + lvl * kP * kP, scale,
                  sg[warp], lane);
  }
}

template <typename TM, typename TT>
cudaError_t launch(dim3 grid, cudaStream_t st, const Levels& lv, int L, int lpw,
                   const void* targets, const long long* ts, const float* cp,
                   const long long* cs, float* op, int S, int N, float scale) {
  corr_sample_points<TM, TT><<<grid, kThreads, 0, st>>>(
      lv, L, lpw, static_cast<const TT*>(targets), ts[0], ts[1], ts[2], cp, cs[0], cs[1], cs[2],
      op, S, N, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// maps: L device pointers, each (B*S, H[l], W[l], C) contiguous and 16-byte
// aligned, a frame's map below 2 GiB; targets (B, S, N, C) with element
// strides tstrides[3] for b, s, n, unit stride over C and 16-byte aligned
// rows; coords (B, S, N, 2) f32 at level-0 scale with strides cstrides[3]
// and unit stride over xy; out (B*S*N, L*49) f32 contiguous. C = 128; radius
// 3; B*S at most 65535. dtype codes: 0 = float32, 1 = bfloat16; (map,
// target) must be (1, 1), (1, 0) or (0, 0).
// The launch, as kernels/corr_cuda.py:launch_plan lays it out: path 1 = the
// tensor cores (bf16 maps and targets), 2 = the tensor cores with the f32
// targets split in three (bf16 maps), 0 = SIMT (f32 maps); lpw, the
// levels a warp takes (1 .. L); grid = ceil(N / 8) * B*S * ceil(L / lpw)
// blocks of 8 warps. A plan that differs is refused.
int pips_corr_sample_fwd(const void* const* maps, const int* hs, const int* ws, int L,
                         const void* targets, const long long* tstrides,
                         const void* coords, const long long* cstrides, void* out,
                         int B, int S, int N, int C, int map_dtype, int tgt_dtype,
                         int path, int lpw, int grid, float scale, int device,
                         void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || S < 1 || N < 1 || C != kC ||
      (map_dtype == 0 && tgt_dtype != 0) || map_dtype < 0 || map_dtype > 1 || tgt_dtype < 0 ||
      tgt_dtype > 1 || path != (map_dtype == 1 ? (tgt_dtype == 1 ? 1 : 2) : 0) ||
      (long long)B * S > 65535 || lpw < 1 || lpw > L)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((N + kWarps - 1) / kWarps, B * S, (L + lpw - 1) / lpw);
  if ((long long)grid != (long long)blocks.x * blocks.y * blocks.z)
    return (int)cudaErrorInvalidValue;
  const int elem = map_dtype == 1 ? 2 : 4;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    // a frame's map within 32-bit byte offsets
    if (hs[l] < 1 || ws[l] < 1 || (long long)hs[l] * ws[l] * kC * elem >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    lv.map[l] = maps[l];
    lv.H[l] = hs[l];
    lv.W[l] = ws[l];
  }
  for (int l = L; l < kMaxLevels; ++l) {
    lv.map[l] = nullptr;
    lv.H[l] = lv.W[l] = 1;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(coords);
  float* op = static_cast<float*>(out);
  if (path == 1)
    return (int)launch<bf16, bf16>(blocks, st, lv, L, lpw, targets, tstrides, cp, cstrides, op, S,
                                   N, scale);
  if (path == 2)
    return (int)launch<bf16, float>(blocks, st, lv, L, lpw, targets, tstrides, cp, cstrides, op,
                                    S, N, scale);
  return (int)launch<float, float>(blocks, st, lv, L, lpw, targets, tstrides, cp, cstrides, op, S,
                                   N, scale);
}

}  // extern "C"
