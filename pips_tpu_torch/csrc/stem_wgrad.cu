// Weight gradient of the encoder stem's conv in its W-space-to-depth form:
// stride (2, 1), VALID, 7x4 taps, 6 -> 64 channels,
//   dk[o, c, ky, kx] = sum_{b, h, w'} x2[b, 2h + ky, w' + kx, c] * dy[b, h, w', o]
// with x2 (B, Hp, Wp, 6) and dy (B, Ho, Wo, 64) NHWC in memory
// (torch.channels_last), bf16 or f32 operands, f32 sums, dk f32 in
// F.conv2d's weight layout (64, 6, 7, 4).
//
// Replaces the TPU kernel pips_tpu/kernels/stem_wgrad_pallas.py:stem_wgrad
// (pallas_call of _wgrad_kernel), the weight gradient of stem_conv_s2d.
//
// What bounds it on an H100: dk is a (168 x 64) product over K = B*Ho*Wo
// pixels: 2*168*64 operations per pixel against 64 + 3 (x2 is 6 channels at
// half the rows, read once) bf16 values per pixel. At B=8, 384x512 that is
// 8.5 GFLOP (0.009 ms at 989 TFLOP/s) against 60 MB (0.018 ms at 3.35 TB/s):
// bound by bytes, dy above all. The TPU design exists to keep the row-tap
// tensor x7[b, h, w', ky*6 + c] = x2[b, 2h + ky, w', c] out of HBM; here x2 is
// read in place at row stride 2 and x7 exists only as rows in shared memory.
//
// Design (plain; making it fast is later work). Work is cut into segments of
// one output row (b, h) and up to 128 columns. Each block walks a contiguous
// run of segments: it stages the seven input rows 2h..2h+6 (131 columns, six
// channels: a bf16 pixel is 12 bytes, so no 16-byte vector loads of x2) and the
// segment's dy (16-byte loads) in shared memory as f32, then each of its 336
// threads owns one (ky, c) and 8 outputs o for all four kx: per column it
// slides a four-value window of x along the row (one new load) and reads eight
// dy values, for 32 FMAs. Products of bf16 operands are exact in f32. Each block
// writes its 10,752 partial sums; a second small launch adds the blocks'
// partials in block order, so the result is deterministic without atomics.
//
// Plain C ABI (loaded with ctypes): pips_stem_wgrad_blocks gives the number of
// partial rows of the scratch; pips_stem_wgrad returns cudaGetLastError()
// after the launches; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KY = 7, KX = 4, C = 6, O = 64;
constexpr int kRows = KY * C;            // 42 (ky, c) pairs
constexpr int kOut = KY * KX * C * O;    // 10,752 outputs
constexpr int kOG = 8;                   // outputs per thread
constexpr int kThreads = kRows * (O / kOG);  // 336
constexpr int SW = 128;                  // output columns per segment
constexpr int XW = SW + KX - 1;          // input columns staged per segment
constexpr size_t kXBytes = (size_t)KY * XW * C * 4;  // 22,008: [ky][w][c] f32
constexpr size_t kDBytes = (size_t)SW * O * 4;       // 32,768: [w][o] f32
constexpr size_t kSmem = kDBytes + kXBytes;          // 54,776
constexpr int kReduceThreads = 256;
static_assert(kDBytes % 16 == 0, "dy stage alignment");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// eight dy values (one 16-byte load of bf16, two of f32) widened to f32
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_wgrad_partial(const T* __restrict__ x2, const T* __restrict__ dy,
                   float* __restrict__ part, int B, int Hp, int Wp, int Ho, int Wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ds = reinterpret_cast<float*>(smem);            // [SW][O]
  float* xs = reinterpret_cast<float*>(smem + kDBytes);  // [KY][XW][C]

  const int tid = threadIdx.x;
  const int og = tid % (O / kOG), rc = tid / (O / kOG);  // outputs og*8.., row (ky, c)
  const int ky = rc / C, c = rc % C;
  const int segs_w = (Wo + SW - 1) / SW;
  const long nseg = (long)B * Ho * segs_w;
  const long s0 = nseg * blockIdx.x / gridDim.x, s1 = nseg * (blockIdx.x + 1) / gridDim.x;

  float acc[KX][kOG];
#pragma unroll
  for (int kx = 0; kx < KX; ++kx)
#pragma unroll
    for (int j = 0; j < kOG; ++j) acc[kx][j] = 0.0f;

  for (long sg = s0; sg < s1; ++sg) {
    const int w0 = (int)(sg % segs_w) * SW;
    const long bh = sg / segs_w;
    const int h = (int)(bh % Ho), b = (int)(bh / Ho);
    const int nw = min(SW, Wo - w0);  // output columns of this segment
    __syncthreads();  // the previous segment is consumed

    // dy row (b, h), columns w0 .. w0+SW-1: 8 channels per item, zeros past Wo
    const T* dyr = dy + (((size_t)b * Ho + h) * Wo + w0) * O;
    for (int i = tid; i < SW * (O / 8); i += kThreads) {
      const int w = i / (O / 8), k = (i % (O / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (w < nw) load8(dyr + (size_t)w * O + k, v);
      float4* d = reinterpret_cast<float4*>(ds + w * O + k);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    // the seven input rows 2h + ky, columns w0 .. w0+XW-1 (six contiguous
    // channels each); columns past the segment's last tap read as zero
    for (int i = tid; i < KY * XW * C; i += kThreads) {
      const int r = i / (XW * C), rest = i % (XW * C);
      const int w = rest / C;
      float v = 0.0f;
      if (w < nw + KX - 1)
        v = to_f(x2[(((size_t)b * Hp + 2 * h + r) * Wp + w0) * C + rest]);
      xs[i] = v;
    }
    __syncthreads();

    const float* xr = xs + ky * XW * C + c;
    float win[KX];
#pragma unroll
    for (int kx = 0; kx < KX - 1; ++kx) win[kx + 1] = xr[kx * C];
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
#pragma unroll
      for (int kx = 0; kx < KX - 1; ++kx) win[kx] = win[kx + 1];
      win[KX - 1] = xr[(w + KX - 1) * C];
      const float4 d0 = *reinterpret_cast<const float4*>(ds + w * O + og * kOG);
      const float4 d1 = *reinterpret_cast<const float4*>(ds + w * O + og * kOG + 4);
      const float d[kOG] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int kx = 0; kx < KX; ++kx)
#pragma unroll
        for (int j = 0; j < kOG; ++j) acc[kx][j] = fmaf(win[kx], d[j], acc[kx][j]);
    }
  }

  // this block's partial dk in dk's layout [o][c][ky][kx]
  float* pb = part + (size_t)blockIdx.x * kOut;
#pragma unroll
  for (int j = 0; j < kOG; ++j) {
    const int o = og * kOG + j;
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) pb[((o * C + c) * KY + ky) * KX + kx] = acc[kx][j];
  }
}

// dk[i] = sum over blocks, in block order
__global__ void __launch_bounds__(kReduceThreads)
stem_wgrad_sum(const float* __restrict__ part, float* __restrict__ dk, int nblocks) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= kOut) return;
  float v = 0.0f;
  for (int k = 0; k < nblocks; ++k) v += part[(size_t)k * kOut + i];
  dk[i] = v;
}

template <typename T>
cudaError_t launch(const void* x2, const void* dy, float* dk, float* part, int nblocks, int B,
                   int Hp, int Wp, int Ho, int Wo, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(stem_wgrad_partial<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  stem_wgrad_partial<T><<<nblocks, kThreads, kSmem, s>>>(
      static_cast<const T*>(x2), static_cast<const T*>(dy), part, B, Hp, Wp, Ho, Wo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stem_wgrad_sum<<<(kOut + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, dk, nblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the partial launch, so rows of the scratch (nblocks, 10752) f32:
// as many as fit the card at once, at most one per segment.
int pips_stem_wgrad_blocks(int B, int Ho, int Wo, int device) {
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaFuncSetAttribute(stem_wgrad_partial<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_wgrad_partial<bf16>, kThreads,
                                                    kSmem) != cudaSuccess)
    return -1;
  const long nseg = (long)B * Ho * ((Wo + SW - 1) / SW);
  const long resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(nseg < resident ? nseg : resident);
}

// Shapes the kernel takes: x2 (B, 6, Hp, Wp) and dy (B, 64, Ho, Wo), both
// contiguous NHWC in memory (torch.channels_last), one dtype; Hp >= 2*Ho + 5,
// Wp >= Wo + 3; dk (64, 6, 7, 4) float32; part (nblocks, 10752) float32 with
// nblocks from pips_stem_wgrad_blocks; pointers 16-byte aligned.
// dtype_code 0 = float32, 1 = bfloat16 (x2, dy).
int pips_stem_wgrad(const void* x2, const void* dy, void* dk, void* part, int nblocks, int B,
                    int Hp, int Wp, int Ho, int Wo, int dtype_code, int device, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || Hp < 2 * Ho + KY - 2 || Wp < Wo + KX - 1 || nblocks <= 0 ||
      (dtype_code != 0 && dtype_code != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(dk);
  float* p = static_cast<float*>(part);
  err = dtype_code == 1 ? launch<bf16>(x2, dy, d, p, nblocks, B, Hp, Wp, Ho, Wo, s)
                        : launch<float>(x2, dy, d, p, nblocks, B, Hp, Wp, Ho, Wo, s);
  return (int)err;
}

}  // extern "C"
