// Host data-plane kernels of pips_tpu_torch (a copy of the JAX package's
// native/pips_host.cpp, plus the colour-jitter, hue and blur entries that
// replace the augmentations' cv2 calls).
//
// The training input pipeline's host-CPU hot loops (FlyingThings++ sample
// assembly: PFM mask decode, occluder compositing, per-frame bilinear
// resizing, visibility bookkeeping, photometric jitter and blur; see
// pips_tpu_torch/data/) implemented natively and exposed through a C ABI for
// ctypes. The device path stays in PyTorch and the CUDA kernels; this keeps
// the host feed from stalling the card.
//
// Built at first use by pips_tpu_torch/native/lib.py:
//   g++ -O3 -fPIC -shared -fopenmp -std=c++17

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

// Below this much work a call stays on its caller's thread: the data
// loader already runs one sample per thread, and waking a thread team for
// a small crop costs more than the work.
static const int64_t kParallelMin = 1 << 16;

extern "C" {

// ---------------------------------------------------------------------------
// PFM decode: parse header + big/little endian float payload, flip rows.
// Returns 0 on success; fills width/height/channels. `out` must hold
// height*width*channels floats (call once with out=nullptr to query dims).
// ---------------------------------------------------------------------------
int pips_decode_pfm(const uint8_t* buf, int64_t len, float* out,
                    int32_t* width, int32_t* height, int32_t* channels) {
  if (len < 8) return -1;
  int64_t pos = 0;
  auto read_line = [&](char* dst, int maxlen) -> bool {
    int i = 0;
    while (pos < len && i < maxlen - 1) {
      char c = static_cast<char>(buf[pos++]);
      if (c == '\n') break;
      dst[i++] = c;
    }
    dst[i] = 0;
    return i > 0;
  };

  char line[128];
  if (!read_line(line, sizeof line)) return -2;
  int ch;
  if (strcmp(line, "PF") == 0) ch = 3;
  else if (strcmp(line, "Pf") == 0) ch = 1;
  else return -3;

  if (!read_line(line, sizeof line)) return -4;
  int w, h;
  if (sscanf(line, "%d %d", &w, &h) != 2) return -5;

  if (!read_line(line, sizeof line)) return -6;
  double scale = atof(line);
  bool little_endian = scale < 0;

  *width = w;
  *height = h;
  *channels = ch;
  if (out == nullptr) return 0;

  int64_t n = static_cast<int64_t>(w) * h * ch;
  if (len - pos < n * 4) return -7;
  const uint8_t* data = buf + pos;

  // rows are stored bottom-up
  for (int y = 0; y < h; y++) {
    const uint8_t* src_row = data + static_cast<int64_t>(h - 1 - y) * w * ch * 4;
    float* dst_row = out + static_cast<int64_t>(y) * w * ch;
    if (little_endian) {
      memcpy(dst_row, src_row, static_cast<size_t>(w) * ch * 4);
    } else {
      for (int i = 0; i < w * ch; i++) {
        uint32_t v;
        memcpy(&v, src_row + i * 4, 4);
        v = __builtin_bswap32(v);
        memcpy(dst_row + i, &v, 4);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Occluder compositing over a whole clip:
//   rgb[s] = rgb[s] * (1 - mask[s]) + alt[s] * mask[s]
// rgb/alt: (S, H, W, 3) float32; mask: (S, H, W) float32 in [0, 1].
// ---------------------------------------------------------------------------
void pips_composite(float* rgb, const float* alt, const float* mask,
                    int32_t S, int32_t H, int32_t W) {
  const int64_t hw = static_cast<int64_t>(H) * W;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(S) * hw >= kParallelMin)
#endif
  for (int64_t i = 0; i < static_cast<int64_t>(S) * hw; i++) {
    float m = mask[i];
    if (m == 0.0f) continue;
    float inv = 1.0f - m;
    rgb[i * 3 + 0] = rgb[i * 3 + 0] * inv + alt[i * 3 + 0] * m;
    rgb[i * 3 + 1] = rgb[i * 3 + 1] * inv + alt[i * 3 + 1] * m;
    rgb[i * 3 + 2] = rgb[i * 3 + 2] * inv + alt[i * 3 + 2] * m;
  }
}

// ---------------------------------------------------------------------------
// Bilinear resize (half-pixel centers, cv2.INTER_LINEAR semantics).
// src: (H, W, C) float32 -> dst: (H2, W2, C).
// ---------------------------------------------------------------------------
void pips_resize_bilinear(const float* src, int32_t H, int32_t W, int32_t C,
                          float* dst, int32_t H2, int32_t W2) {
  const float sy = static_cast<float>(H) / H2;
  const float sx = static_cast<float>(W) / W2;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(H2) * W2 * C >= kParallelMin)
#endif
  for (int y = 0; y < H2; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), H - 1);
    int y1c = std::min(std::max(y0 + 1, 0), H - 1);
    for (int x = 0; x < W2; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(floorf(fx));
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), W - 1);
      int x1c = std::min(std::max(x0 + 1, 0), W - 1);
      const float* p00 = src + (static_cast<int64_t>(y0c) * W + x0c) * C;
      const float* p01 = src + (static_cast<int64_t>(y0c) * W + x1c) * C;
      const float* p10 = src + (static_cast<int64_t>(y1c) * W + x0c) * C;
      const float* p11 = src + (static_cast<int64_t>(y1c) * W + x1c) * C;
      float* d = dst + (static_cast<int64_t>(y) * W2 + x) * C;
      for (int c = 0; c < C; c++) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        d[c] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward-flow trajectory chaining for dataset generation
// (pips_tpu_torch/datagen/trajs.py hot loop): one step for all points.
// flow: (H, W, 2); coords: (N, 2) updated in place (sampled at rounded,
// border-replicated positions — reference make_trajs.py semantics).
// ---------------------------------------------------------------------------
void pips_chain_step(const float* flow, int32_t H, int32_t W,
                     float* coords, int64_t N) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (N >= kParallelMin)
#endif
  for (int64_t n = 0; n < N; n++) {
    float x = roundf(coords[n * 2 + 0]);
    float y = roundf(coords[n * 2 + 1]);
    // border-replicating bilinear at integer coords == clamped pixel lookup
    int xi = std::min(std::max(static_cast<int>(x), 0), W - 1);
    int yi = std::min(std::max(static_cast<int>(y), 0), H - 1);
    const float* f = flow + (static_cast<int64_t>(yi) * W + xi) * 2;
    coords[n * 2 + 0] += f[0];
    coords[n * 2 + 1] += f[1];
  }
}

// ---------------------------------------------------------------------------
// Deferred occluder coverage, one frame (pips_tpu_torch/data/flyingthings.py
// _mark_covered_by_later_layers): zero vis[n] where the topmost pasted
// layer at the point's rounded in-bounds pixel is newer than the point's
// own birth layer. nearbyintf under the default rounding mode matches
// np.round (round-half-to-even).
// painter: (H, W) uint8; trajs: (N, 2) float32; birth: (N) int32;
// vis: (N) float32, zeroed in place.
// ---------------------------------------------------------------------------
void pips_mark_covered_frame(const uint8_t* painter, const float* trajs,
                             const int32_t* birth, float* vis,
                             int32_t H, int32_t W, int64_t N) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (N >= kParallelMin)
#endif
  for (int64_t n = 0; n < N; n++) {
    int ix = static_cast<int>(nearbyintf(trajs[n * 2 + 0]));
    int iy = static_cast<int>(nearbyintf(trajs[n * 2 + 1]));
    if (ix < 0 || ix > W - 1 || iy < 0 || iy > H - 1) continue;
    if (static_cast<int32_t>(painter[static_cast<int64_t>(iy) * W + ix])
        > birth[n]) {
      vis[n] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Post-aug visibility bookkeeping, one frame (pips_tpu_torch/data/flyingthings.py
// visibility_filter): a point on an occ==255 padding pixel (rounded coords,
// in-bounds) or out of bounds (unrounded coords) becomes invisible; also
// emits the float-coords in-bounds mask the trajectory filters consume.
// occ: (H, W) float32; trajs: (N, 2) float32; vis: (N) float32 in/out;
// inb_f: (N) uint8 out (0/1).
// ---------------------------------------------------------------------------
void pips_visibility_frame(const float* trajs, const float* occ,
                           float* vis, uint8_t* inb_f,
                           int32_t H, int32_t W, int64_t N) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (N >= kParallelMin)
#endif
  for (int64_t n = 0; n < N; n++) {
    float x = trajs[n * 2 + 0];
    float y = trajs[n * 2 + 1];
    int rx = static_cast<int>(nearbyintf(x));
    int ry = static_cast<int>(nearbyintf(y));
    bool inb_r = rx >= 0 && rx <= W - 1 && ry >= 0 && ry <= H - 1;
    int xcl = std::min(std::max(rx, 0), W - 1);
    int ycl = std::min(std::max(ry, 0), H - 1);
    bool on_pad = occ[static_cast<int64_t>(ycl) * W + xcl] == 255.0f;
    bool inf = x >= 0.0f && x <= static_cast<float>(W - 1)
            && y >= 0.0f && y <= static_cast<float>(H - 1);
    if ((on_pad && inb_r) || !inf) vis[n] = 0.0f;
    inb_f[n] = inf ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Eraser/replace-aug coverage (pips_tpu_torch/data/augs.py _mark_in_rects):
// zero vis[n] where the float point lies in any half-open integer rect.
// rects: (R, 4) int32 rows (x0, x1, y0, y1). Definitional semantics —
// (x >= x0) & (x < x1) & (y >= y0) & (y < y1) — with early exit; most
// points fail the first compare, so this is ~2 compares/point.
// ---------------------------------------------------------------------------
void pips_mark_in_rects(const float* trajs, const int32_t* rects, int32_t R,
                        float* vis, int64_t N) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (N * R >= kParallelMin)
#endif
  for (int64_t n = 0; n < N; n++) {
    float x = trajs[n * 2 + 0];
    float y = trajs[n * 2 + 1];
    for (int32_t r = 0; r < R; r++) {
      const int32_t* rc = rects + r * 4;
      if (x >= static_cast<float>(rc[0]) && x < static_cast<float>(rc[1])
          && y >= static_cast<float>(rc[2]) && y < static_cast<float>(rc[3])) {
        vis[n] = 0.0f;
        break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Colour jitter's affine map on uint8 RGB, as cv2.transform computes it for
// 8-bit 3-channel images: the 3x4 matrix in 10-bit fixed point (m, rounded
// by the caller), dst[c] = sat_u8((sum_k m[c][k] * x[k] + m[c][3] + 512) >> 10).
// src/dst: (n, 3) uint8; m: 12 int32, row-major (3, 4).
// ---------------------------------------------------------------------------
void pips_color_affine_u8(const uint8_t* src, uint8_t* dst, int64_t n,
                          const int32_t* m) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n >= kParallelMin)
#endif
  for (int64_t i = 0; i < n; i++) {
    const int32_t x0 = src[i * 3 + 0], x1 = src[i * 3 + 1], x2 = src[i * 3 + 2];
    for (int c = 0; c < 3; c++) {
      const int32_t* r = m + c * 4;
      int64_t acc = static_cast<int64_t>(r[0]) * x0 + static_cast<int64_t>(r[1]) * x1
                  + static_cast<int64_t>(r[2]) * x2 + r[3] + 512;
      acc >>= 10;
      dst[i * 3 + c] = static_cast<uint8_t>(acc < 0 ? 0 : (acc > 255 ? 255 : acc));
    }
  }
}

// ---------------------------------------------------------------------------
// Hue shift on uint8 RGB in cv2's 8-bit HSV convention (H in [0, 180)):
// RGB -> HSV as cv2.cvtColor(COLOR_RGB2HSV) computes it (12-bit division
// tables), H += shift mod 180, HSV -> RGB as cv2.cvtColor(COLOR_HSV2RGB)
// computes it (f32 with fused multiply-adds, truncated). src/dst: (n, 3).
// ---------------------------------------------------------------------------
void pips_hue_shift_u8(const uint8_t* src, uint8_t* dst, int64_t n,
                       int32_t shift) {
  const int kShift = 12;
  int32_t sdiv[256], hdiv[256];
  sdiv[0] = hdiv[0] = 0;
  for (int i = 1; i < 256; i++) {
    sdiv[i] = static_cast<int32_t>(nearbyint((255 << kShift) / (1.0 * i)));
    hdiv[i] = static_cast<int32_t>(nearbyint((180 << kShift) / (6.0 * i)));
  }
  const float hscale = static_cast<float>(6.0 / 180.0);
  const float unit = static_cast<float>(1.0 / 255.0);
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const int32_t dh = ((shift % 180) + 180) % 180;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n >= kParallelMin)
#endif
  for (int64_t i = 0; i < n; i++) {
    const int32_t r = src[i * 3 + 0], g = src[i * 3 + 1], b = src[i * 3 + 2];
    const int32_t v = std::max(std::max(r, g), b);
    const int32_t vmin = std::min(std::min(r, g), b);
    const int32_t diff = v - vmin;
    const int32_t s = (diff * sdiv[v] + (1 << (kShift - 1))) >> kShift;
    int32_t h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + (1 << (kShift - 1))) >> kShift;
    if (h < 0) h += 180;
    h = (h + dh) % 180;

    const float hf = static_cast<float>(h) * hscale;
    const float sf = static_cast<float>(s) * unit;
    const float vf = static_cast<float>(v) * unit;
    const int sector = static_cast<int>(floorf(hf)) % 6;
    const float f = hf - floorf(hf);
    float tab[4];
    tab[0] = vf;
    tab[1] = vf * fmaf(-sf, 1.0f, 1.0f);
    tab[2] = vf * fmaf(-sf, f, 1.0f);
    tab[3] = vf * fmaf(-sf, 1.0f - f, 1.0f);
    const float bgr[3] = {tab[sector_data[sector][0]], tab[sector_data[sector][1]],
                          tab[sector_data[sector][2]]};
    for (int c = 0; c < 3; c++) {
      const float x = bgr[2 - c] * 255.0f;  // RGB order out
      const int q = static_cast<int>(x);    // truncation
      dst[i * 3 + c] = static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
    }
  }
}

// BORDER_REFLECT_101 index, as cv2's borderInterpolate.
static inline int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// ---------------------------------------------------------------------------
// Separable Gaussian blur of uint8 images, as cv2.GaussianBlur computes it
// for 8-bit images: taps k (n odd, 8 fractional bits, summing to 256),
// rows then columns in exact integer arithmetic, BORDER_REFLECT_101, the
// result rounded half up from 16 fractional bits.
// src/dst: (H, W, C) uint8, C <= 4; k: n int32.
// ---------------------------------------------------------------------------
int pips_gaussian_blur_u8(const uint8_t* src, uint8_t* dst, int32_t H, int32_t W,
                          int32_t C, const int32_t* k, int32_t n) {
  if (n < 1 || (n & 1) == 0 || C < 1 || C > 4) return -1;
  const int r = n / 2;
  const int64_t row = static_cast<int64_t>(W) * C;
  uint32_t* tmp = static_cast<uint32_t*>(malloc(sizeof(uint32_t) * H * row));
  int32_t* xoff = static_cast<int32_t*>(malloc(sizeof(int32_t) * W * n));
  int64_t* yoff = static_cast<int64_t*>(malloc(sizeof(int64_t) * H * n));
  if (tmp == nullptr || xoff == nullptr || yoff == nullptr) {
    free(tmp);
    free(xoff);
    free(yoff);
    return -2;
  }
  for (int x = 0; x < W; x++)
    for (int i = 0; i < n; i++) xoff[x * n + i] = reflect101(x + i - r, W) * C;
  for (int y = 0; y < H; y++)
    for (int i = 0; i < n; i++) yoff[y * n + i] = reflect101(y + i - r, H) * row;
  const int64_t work = static_cast<int64_t>(H) * row * n;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (work >= kParallelMin)
#endif
  for (int y = 0; y < H; y++) {
    const uint8_t* s = src + y * row;
    uint32_t* t = tmp + y * row;
    for (int x = 0; x < W; x++) {
      uint32_t acc[4] = {0, 0, 0, 0};
      const int32_t* xo = xoff + x * n;
      for (int i = 0; i < n; i++) {
        const uint8_t* p = s + xo[i];
        const uint32_t w = static_cast<uint32_t>(k[i]);
        for (int c = 0; c < C; c++) acc[c] += w * p[c];
      }
      for (int c = 0; c < C; c++) t[static_cast<int64_t>(x) * C + c] = acc[c];
    }
  }
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (work >= kParallelMin)
#endif
  for (int y = 0; y < H; y++) {
    uint8_t* d = dst + y * row;
    const int64_t* yo = yoff + static_cast<int64_t>(y) * n;
    for (int64_t j = 0; j < row; j++) {
      uint32_t acc = 0;  // at most 256 * 255 * 256
      for (int i = 0; i < n; i++) acc += static_cast<uint32_t>(k[i]) * tmp[yo[i] + j];
      const uint32_t q = (acc + (1u << 15)) >> 16;
      d[j] = static_cast<uint8_t>(q > 255 ? 255 : q);
    }
  }
  free(tmp);
  free(xoff);
  free(yoff);
  return 0;
}

int pips_native_version() { return 4; }

}  // extern "C"
