"""Build, load and call the port's host data-plane library (counterpart of
``pips_tpu/native/lib.py``).

The C++ source is ``pips_host.cpp`` beside this file. At first use it is
compiled with the flags of the JAX package's ``native/build.sh`` into
``<repo>/build/pips_tpu_torch/libpipshost-<hash>.so``, keyed by a hash of the
source and flags, so a stale library is never loaded. A failed build or load
raises: there is no silent fallback. Each entry keeps its numpy form beside
it (``*_reference``), the JAX package's fallbacks and the cv2-free forms of
the augmentations' cv2 calls; the tests and the chip smoke hold each C entry
against it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("pips_host.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pips_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i32, _i64 = ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "pips_decode_pfm": ([_u8p, _i64, _f32p, _i32p, _i32p, _i32p], ctypes.c_int),
    "pips_composite": ([_f32p, _f32p, _f32p, _i32, _i32, _i32], None),
    "pips_resize_bilinear": ([_f32p, _i32, _i32, _i32, _f32p, _i32, _i32], None),
    "pips_chain_step": ([_f32p, _i32, _i32, _f32p, _i64], None),
    "pips_mark_covered_frame": ([_u8p, _f32p, _i32p, _f32p, _i32, _i32, _i64], None),
    "pips_visibility_frame": ([_f32p, _f32p, _f32p, _u8p, _i32, _i32, _i64], None),
    "pips_mark_in_rects": ([_f32p, _i32p, _i32, _f32p, _i64], None),
    "pips_color_affine_u8": ([_u8p, _u8p, _i64, _i32p], None),
    "pips_hue_shift_u8": ([_u8p, _u8p, _i64, _i32], None),
    "pips_gaussian_blur_u8": ([_u8p, _u8p, _i32, _i32, _i32, _i32p, _i32], ctypes.c_int),
    "pips_native_version": ([], ctypes.c_int),
}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpipshost-{h.hexdigest()[:16]}.so"


def _compilers() -> list[str]:
    """``$CXX`` when set, then ``g++``: a ``$CXX`` meant for another build
    (one without OpenMP's runtime, say) does not stop this one."""
    cxx = os.environ.get("CXX")
    return [cxx, "g++"] if cxx and cxx != "g++" else ["g++"]


def _build(out: Path) -> None:
    """Compile into a temporary file beside ``out``, then rename it into
    place, so processes that build at once never load a half-written file.
    Raises with every compiler's output when none succeeds."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=out.stem + ".", dir=out.parent)
    os.close(fd)
    errors = []
    try:
        for cxx in _compilers():
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            if res.returncode == 0:
                os.replace(tmp, out)
                return
            errors.append(f"{' '.join(cmd)}:\n{res.stdout}{res.stderr}")
        raise RuntimeError("building the host library failed:\n" + "\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def ensure_built(force: bool = False) -> bool:
    """Compile the library if it has not been built for this source (always
    with ``force``) and load it. Returns True; raises when either fails."""
    global _lib
    if force:
        with _lock:
            _build(library_path())
            _lib = None
    _load()
    return True


def available() -> bool:
    """True once the library is built and loaded; raises when it cannot be."""
    return ensure_built()


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# ---- PFM ---------------------------------------------------------------------

def decode_pfm(data: bytes) -> np.ndarray:
    """PFM bytes -> (H, W[, 3]) float32 (top-down rows)."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w, h, c = _i32(), _i32(), _i32()
    rc = lib.pips_decode_pfm(_ptr(buf, _u8p), len(data), None, ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"invalid PFM (code {rc})")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.pips_decode_pfm(_ptr(buf, _u8p), len(data), _ptr(out, _f32p), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"PFM decode failed (code {rc})")
    return out[..., 0] if c.value == 1 else out


def decode_pfm_reference(data: bytes) -> np.ndarray:
    """The numpy form: ``data.pfm.read_pfm`` on the bytes."""
    from pips_tpu_torch.data.pfm import read_pfm

    with tempfile.NamedTemporaryFile(suffix=".pfm", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        return read_pfm(path).astype(np.float32)
    finally:
        os.unlink(path)


def decode_pfm_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_pfm(f.read())


# ---- compositing, resizing, chaining -----------------------------------------

def composite(rgb: np.ndarray, alt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """In-place ``rgb = rgb*(1-mask) + alt*mask``. rgb/alt: (S, H, W, 3)
    float32 contiguous; mask: (S, H, W)."""
    lib = _load()
    S, H, W, _ = rgb.shape
    for a in (rgb, alt, mask):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError("composite takes C-contiguous float32 arrays")
    if alt.shape != rgb.shape or mask.shape != rgb.shape[:3]:
        raise ValueError(f"composite: shapes {rgb.shape}, {alt.shape}, {mask.shape}")
    lib.pips_composite(_ptr(rgb, _f32p), _ptr(alt, _f32p), _ptr(mask, _f32p), S, H, W)
    return rgb


def composite_reference(rgb: np.ndarray, alt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    rgb *= (1.0 - mask[..., None])
    rgb += alt * mask[..., None]
    return rgb


def resize_bilinear(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> (H2, W2, C), half-pixel bilinear (cv2 semantics)."""
    lib = _load()
    H2, W2 = out_hw
    src = np.ascontiguousarray(src, np.float32)
    H, W, C = src.shape
    dst = np.empty((H2, W2, C), np.float32)
    lib.pips_resize_bilinear(_ptr(src, _f32p), H, W, C, _ptr(dst, _f32p), H2, W2)
    return dst


def resize_bilinear_reference(src: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """The numpy form, in the C entry's f32 arithmetic and order."""
    src = np.asarray(src, np.float32)
    H, W, _ = src.shape
    H2, W2 = out_hw

    def taps(n_out: int, n_in: int):
        scale = np.float32(n_in) / np.float32(n_out)
        f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale
        f = f - np.float32(0.5)
        i0 = np.floor(f).astype(np.int64)
        w = (f - i0.astype(np.float32)).astype(np.float32)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w

    y0, y1, wy = taps(H2, H)
    x0, x1, wx = taps(W2, W)
    one = np.float32(1)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = src[y0][:, x0] * (one - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (one - wx) + src[y1][:, x1] * wx
    return (top * (one - wy) + bot * wy).astype(np.float32)


def chain_step(flow: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """One forward-flow chaining step, in place. flow: (H, W, 2) float32;
    coords: (N, 2) float32 contiguous."""
    lib = _load()
    flow = np.ascontiguousarray(flow, np.float32)
    if not coords.flags.c_contiguous or coords.dtype != np.float32:
        raise ValueError("chain_step takes C-contiguous float32 coords")
    H, W, _ = flow.shape
    lib.pips_chain_step(_ptr(flow, _f32p), H, W, _ptr(coords, _f32p), coords.shape[0])
    return coords


def chain_step_reference(flow: np.ndarray, coords: np.ndarray) -> np.ndarray:
    H, W, _ = flow.shape
    xi = np.clip(np.round(coords[:, 0]).astype(np.int64), 0, W - 1)
    yi = np.clip(np.round(coords[:, 1]).astype(np.int64), 0, H - 1)
    coords += flow[yi, xi]
    return coords


# ---- point bookkeeping -------------------------------------------------------

def mark_in_rects(trajs_s: np.ndarray, rects: np.ndarray, vis_s: np.ndarray) -> bool:
    """Zero vis_s (N,) where the float point trajs_s (N, 2) lies in any
    half-open integer rect (x0, x1, y0, y1) of rects (R, 4) int32. Arrays
    C-contiguous float32. Returns True (the JAX package's entry returns False
    when its library lacks it)."""
    lib = _load()
    if not (trajs_s.flags.c_contiguous and vis_s.flags.c_contiguous):
        raise ValueError("mark_in_rects takes C-contiguous arrays")
    rects = np.ascontiguousarray(rects, np.int32)
    lib.pips_mark_in_rects(_ptr(trajs_s, _f32p), _ptr(rects, _i32p), rects.shape[0],
                           _ptr(vis_s, _f32p), trajs_s.shape[0])
    return True


def mark_in_rects_reference(trajs_s: np.ndarray, rects: np.ndarray, vis_s: np.ndarray) -> None:
    r = np.asarray(rects, np.float32).reshape(-1, 4)
    x, y = trajs_s[:, 0], trajs_s[:, 1]
    inside = ((x >= r[:, 0, None]) & (x < r[:, 1, None])
              & (y >= r[:, 2, None]) & (y < r[:, 3, None])).any(axis=0)
    vis_s[inside] = 0


def mark_covered_frame(painter: np.ndarray, trajs_s: np.ndarray,
                       birth: np.ndarray, vis_s: np.ndarray) -> None:
    """Zero vis_s (N,) where painter (H, W) at the point's rounded, in-bounds
    pixel holds a layer newer than birth (N,) int32. In place; all arrays
    C-contiguous. The C entry takes a uint8 painter (fewer than 256 layers);
    a wider one takes the numpy form, as in the JAX package."""
    if painter.dtype != np.uint8:
        mark_covered_frame_reference(painter, trajs_s, birth, vis_s)
        return
    lib = _load()
    H, W = painter.shape
    birth = np.ascontiguousarray(birth, np.int32)
    if not (painter.flags.c_contiguous and trajs_s.flags.c_contiguous
            and vis_s.flags.c_contiguous):
        raise ValueError("mark_covered_frame takes C-contiguous arrays")
    lib.pips_mark_covered_frame(_ptr(painter, _u8p), _ptr(trajs_s, _f32p), _ptr(birth, _i32p),
                                _ptr(vis_s, _f32p), H, W, trajs_s.shape[0])


def mark_covered_frame_reference(painter, trajs_s, birth, vis_s) -> None:
    H, W = painter.shape
    xy = trajs_s.round().astype(np.int32)
    xcl = xy[:, 0].clip(0, W - 1)
    ycl = xy[:, 1].clip(0, H - 1)
    inb = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1)
           & (xy[:, 1] >= 0) & (xy[:, 1] <= H - 1))
    vis_s[(painter[ycl, xcl] > birth) & inb] = 0


def visibility_frame(trajs_s: np.ndarray, occ: np.ndarray, vis_s: np.ndarray,
                     inb_f_s: np.ndarray) -> None:
    """One frame of post-aug visibility bookkeeping: zero vis_s where the
    point sits on an occ==255 padding pixel (rounded, in-bounds) or is out
    of bounds in float coords; write the float in-bounds mask to inb_f_s
    (N,) uint8. In place; all arrays C-contiguous float32/uint8."""
    lib = _load()
    H, W = occ.shape
    if not (trajs_s.flags.c_contiguous and occ.flags.c_contiguous
            and vis_s.flags.c_contiguous and inb_f_s.flags.c_contiguous):
        raise ValueError("visibility_frame takes C-contiguous arrays")
    lib.pips_visibility_frame(_ptr(trajs_s, _f32p), _ptr(occ, _f32p), _ptr(vis_s, _f32p),
                              _ptr(inb_f_s, _u8p), H, W, trajs_s.shape[0])


def visibility_frame_reference(trajs_s, occ, vis_s, inb_f_s) -> None:
    H, W = occ.shape
    x, y = trajs_s[:, 0], trajs_s[:, 1]
    xy = trajs_s.round().astype(np.int32)
    xcl = xy[:, 0].clip(0, W - 1)
    ycl = xy[:, 1].clip(0, H - 1)
    inb_r = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1)
             & (xy[:, 1] >= 0) & (xy[:, 1] <= H - 1))
    inf = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    vis_s[((occ[ycl, xcl] == 255) & inb_r) | ~inf] = 0
    inb_f_s[:] = inf


# ---- photometric augmentations (what cv2 computes on uint8 frames) ----------

def _rgb_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def affine_fixed(M: np.ndarray) -> np.ndarray:
    """A (3, 4) colour matrix in cv2.transform's 8-bit fixed point: rounded
    to f32, then to 10 fractional bits."""
    return np.rint(np.asarray(M, np.float32).astype(np.float64) * 1024).astype(np.int32)


def color_affine(img: np.ndarray, M: np.ndarray) -> np.ndarray:
    """``cv2.transform(img, M)`` for an (H, W, 3) uint8 image and a (3, 4)
    matrix (the saturating uint8 output)."""
    lib = _load()
    img = _rgb_u8(img)
    m = np.ascontiguousarray(affine_fixed(M))
    out = np.empty_like(img)
    lib.pips_color_affine_u8(_ptr(img, _u8p), _ptr(out, _u8p), img.shape[0] * img.shape[1],
                             _ptr(m, _i32p))
    return out


def color_affine_reference(img: np.ndarray, M: np.ndarray) -> np.ndarray:
    m = affine_fixed(M).astype(np.int64)
    acc = img.astype(np.int64) @ m[:, :3].T + m[:, 3] + 512
    return np.clip(acc >> 10, 0, 255).astype(np.uint8)


def hue_shift(img: np.ndarray, shift: int) -> np.ndarray:
    """RGB -> HSV -> H += shift (mod 180) -> RGB, as the JAX package's jitter
    does it through ``cv2.cvtColor`` on an (H, W, 3) uint8 image."""
    lib = _load()
    img = _rgb_u8(img)
    out = np.empty_like(img)
    lib.pips_hue_shift_u8(_ptr(img, _u8p), _ptr(out, _u8p), img.shape[0] * img.shape[1],
                          int(shift))
    return out


_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I[1:])]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I[1:]))]).astype(np.int64)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_reference(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8 (H in [0, 180))."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma32(a: np.ndarray, b: np.ndarray, c: float) -> np.ndarray:
    """f32 a*b + c with one rounding (the product is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def hsv_to_rgb_reference(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` on uint8 (H in [0, 180))."""
    f32 = np.float32
    unit = f32(1.0 / 255.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * unit
    v = hsv[..., 2].astype(f32) * unit
    sector = np.floor(h)
    f = (h - sector).astype(f32)
    one = np.ones_like(s)
    tab = np.stack([v, v * _fma32(-s, one, 1.0), v * _fma32(-s, f, 1.0),
                    v * _fma32(-s, (one - f).astype(f32), 1.0)], -1).astype(f32)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    out = np.trunc(bgr * f32(255))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def hue_shift_reference(img: np.ndarray, shift: int) -> np.ndarray:
    hsv = rgb_to_hsv_reference(img)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
    return np.ascontiguousarray(hsv_to_rgb_reference(hsv))


def gaussian_blur(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Separable blur of an (H, W) or (H, W, C) uint8 image with integer
    ``taps`` (8 fractional bits, odd count, summing to 256), as
    ``cv2.GaussianBlur`` computes it for uint8 with those taps
    (BORDER_REFLECT_101)."""
    lib = _load()
    if img.dtype != np.uint8:
        raise ValueError(f"gaussian_blur takes uint8 images, got {img.dtype}")
    src = np.ascontiguousarray(img if img.ndim == 3 else img[..., None])
    taps = np.ascontiguousarray(taps, np.int32)
    out = np.empty_like(src)
    H, W, C = src.shape
    rc = lib.pips_gaussian_blur_u8(_ptr(src, _u8p), _ptr(out, _u8p), H, W, C,
                                   _ptr(taps, _i32p), taps.size)
    if rc != 0:
        raise ValueError(f"gaussian_blur failed (code {rc}; {taps.size} taps)")
    return out if img.ndim == 3 else out[..., 0]


def reflect101(n_out: int, n_in: int, offset: int) -> np.ndarray:
    """Source index of each output position p + offset under
    BORDER_REFLECT_101 (cv2's borderInterpolate)."""
    p = np.arange(n_out) + offset
    if n_in == 1:
        return np.zeros_like(p)
    while ((p < 0) | (p >= n_in)).any():
        p = np.where(p < 0, -p, np.where(p >= n_in, 2 * n_in - 2 - p, p))
    return p


def gaussian_blur_reference(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    x = (img if img.ndim == 3 else img[..., None]).astype(np.int64)
    H, W = x.shape[:2]
    k = np.asarray(taps, np.int64)
    r = k.size // 2
    h = sum(k[i] * x[:, reflect101(W, W, i - r)] for i in range(k.size))
    v = sum(k[i] * h[reflect101(H, H, i - r)] for i in range(k.size))
    out = np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]
