"""Host-side augmentations for point-tracking training (counterpart of
``pips_tpu/data/augs.py``).

Capability parity with the reference pipeline
(``flyingthingsdataset.py:595-846``): eraser & replace occlusion augs,
color jitter + gaussian blur, per-frame drifting scale/stretch, drifting crop
centered on the visible points, h/v flips — all with trajectory/visibility
bookkeeping.

The JAX package computes the colour jitter, hue shift, blur and resize with
cv2 (and changes their meaning where cv2 is missing). Here each is a call
into the port's host library that computes what cv2 computes on these
inputs: ``cv2.transform``'s 8-bit fixed point, cv2's uint8 HSV convention,
``cv2.GaussianBlur``'s 8-bit fixed-point taps (``gaussian_taps``) with
BORDER_REFLECT_101, and INTER_LINEAR's half-pixel bilinear resize. One path
runs on every machine, with or without cv2.
"""

from __future__ import annotations

import math

import numpy as np

from pips_tpu_torch.native import lib as native


def color_jitter(rgb: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.25 / 3.14) -> np.ndarray:
    """torchvision-ColorJitter-strength photometric jitter on uint8 HWC.

    brightness -> contrast -> saturation is a chain of per-pixel linear maps
    in (pixel, channel-mean gray, constants), so it folds into ONE affine
        out = (b*c*s)*x + (b*c*(1-s))*gray(x) + b*mean(x)*(1-c)
    evaluated in one fixed-point pass as ``cv2.transform`` does (gray(x) comes from the 1/3
    off-diagonal terms) instead of three full-image float passes — ~4x
    faster at 540x960, the loader's hottest aug (replace_aug jitters every
    frame twice). Same values up to rounding (cv2 rounds, the float chain
    truncated). The hue shift is cv2's uint8 HSV round trip."""
    b = rng.uniform(1 - brightness, 1 + brightness)
    c = rng.uniform(1 - contrast, 1 + contrast)
    s = rng.uniform(1 - saturation, 1 + saturation)
    img = np.asarray(rgb, np.uint8)
    m = float(img.mean())
    alpha = b * c * s
    beta = b * c * (1.0 - s) / 3.0
    gamma = b * m * (1.0 - c)
    M = np.full((3, 4), beta, np.float64)
    M[:, 3] = gamma
    M[0, 0] += alpha
    M[1, 1] += alpha
    M[2, 2] += alpha
    img = native.color_affine(img, M)  # saturating uint8 output, as cv2.transform's
    if hue > 0:
        h = rng.uniform(-hue, hue) * 180.0  # opencv hue range [0,180)
        img = native.hue_shift(img, int(round(h)))
    return img


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """The integer taps ``cv2.GaussianBlur`` uses on uint8 images: the
    Gaussian normalised in f64 (cv2's ``getGaussianKernelBitExact``), then
    rounded to 8 fractional bits with the rounding error carried from tap to
    tap, the centre taking what makes the sum 256."""
    if ksize % 2 != 1 or sigma <= 0:
        raise ValueError(f"taps need an odd ksize and sigma > 0, got {ksize} and {sigma}")
    scale = -0.125 / (sigma * sigma)
    half = ksize // 2
    vals = [math.exp(float(x * x) * scale) for x in range(1 - ksize, 0, 2)]
    inv = 1.0 / (2.0 * sum(vals) + 1.0)
    taps = np.zeros(ksize, np.int32)
    err = 0.0
    for i, v in enumerate(vals):
        adj = v * inv * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        taps[i] = taps[ksize - 1 - i] = q
    taps[half] = 256 - 2 * int(taps[:half].sum())
    return taps


def gaussian_blur(rgb: np.ndarray, rng: np.random.RandomState,
                  ksize: int = 11, sigma_range=(0.1, 2.0)) -> np.ndarray:
    sigma = rng.uniform(*sigma_range)
    return native.gaussian_blur(np.asarray(rgb, np.uint8), gaussian_taps(ksize, sigma))


def resize_linear(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)`` for an
    (H, W) or (H, W, C) frame: half-pixel bilinear in f32 through the host
    library. A uint8 frame is rounded back to uint8 (cv2 works there in
    fixed point: within one level of it); any other keeps its dtype."""
    src = img if img.ndim == 3 else img[..., None]
    out = native.resize_bilinear(src, size_hw)
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    elif img.dtype != np.float32:
        out = out.astype(img.dtype)
    return out if img.ndim == 3 else out[..., 0]


def resize_nearest(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)``: output
    pixel (y, x) takes source pixel (floor(y * H_in / H), floor(x * W_in / W))."""
    H2, W2 = size_hw
    H, W = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(H2) * (1.0 / (H2 / H))).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(W2) * (1.0 / (W2 / W))).astype(np.int64), W - 1)
    return img[ys][:, xs]


def _quantize_points(xy: np.ndarray, H: int, W: int):
    """Floor-quantized in-frame point cells: (idx, ix, iy) where idx indexes
    the points whose floor cell lies inside (H, W). For integer rect bounds,
    x in [x0, x1) <=> floor(x) in [x0, x1) (and any point whose floor cell
    is outside the frame cannot be inside a rect), so rect membership
    reduces to one raster gather at these cells."""
    ix = np.floor(xy[:, 0]).astype(np.int32)
    iy = np.floor(xy[:, 1]).astype(np.int32)
    idx = np.nonzero((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H))[0]
    return idx, ix[idx], iy[idx]


def _frame_pts(cache, s: int, xy: np.ndarray, H: int, W: int):
    """Per-frame quantized-point cache: trajs don't move during the
    photometric stack, so eraser_aug and replace_aug share one
    quantization per frame (``photometric_augs`` threads the dict)."""
    if cache is None:
        return _quantize_points(xy, H, W)
    if s not in cache:
        cache[s] = _quantize_points(xy, H, W)
    return cache[s]


def _mark_in_rects(xy: np.ndarray, rects, vis_row: np.ndarray,
                   hw=None, pts_cache=None, frame=None) -> None:
    """Zero vis_row (N,) where xy (N, 2) falls inside any (x0, x1, y0, y1)
    half-open integer rect: rasterize the rects into a bool mask and gather
    it ONCE at the floor-quantized point cells. Exactly equivalent to
    per-rect float compares (bounds are integers — see ``_quantize_points``)
    but O(N + rect area) instead of O(R*N) (N runs ~1e5 once occluder
    trajectories join the pool; R up to 20 rects/frame)."""
    if not rects:
        return
    if (xy.dtype == np.float32 and vis_row.dtype == np.float32
            and xy.flags.c_contiguous and vis_row.flags.c_contiguous):
        native.mark_in_rects(xy, np.asarray(rects, np.int32), vis_row)
        return
    if hw is None:
        r = np.asarray(rects, np.int32)
        hw = (int(r[:, 3].max()), int(r[:, 1].max()))
    H, W = hw
    idx, ix, iy = _frame_pts(pts_cache, frame, xy, H, W)
    if idx.size == 0:
        return
    mask = np.zeros((H, W), np.bool_)
    for x0, x1, y0, y1 in rects:
        mask[y0:y1, x0:x1] = True
    hit = mask[iy, ix]
    vis_row[idx[hit]] = 0


def eraser_aug(rgbs: list[np.ndarray], trajs: np.ndarray, visibles: np.ndarray,
               rng: np.random.RandomState, prob: float = 0.9,
               bounds=(2, 100), max_count: int = 10, pts_cache=None):
    """Fill random rects (frames s>=1) with their mean color; points inside
    become invisible (reference ``flyingthingsdataset.py:607-630``).

    Compositing is uint8-native (rect mean rounds to the nearest uint8,
    ±1 LSB vs carrying float frames) — the full-frame float round-trips
    were most of this aug's cost."""
    S = len(rgbs)
    H, W = rgbs[0].shape[:2]
    rgbs = [np.array(r, np.uint8) for r in rgbs]  # owned copies
    for i in range(1, S):
        if rng.rand() < prob:
            rects = []
            for _ in range(rng.randint(1, max_count + 1)):
                xc, yc = rng.randint(0, W), rng.randint(0, H)
                dx = rng.randint(bounds[0], bounds[1])
                dy = rng.randint(bounds[0], bounds[1])
                x0 = int(np.clip(xc - dx / 2, 0, W - 1).round())
                x1 = int(np.clip(xc + dx / 2, 0, W - 1).round())
                y0 = int(np.clip(yc - dy / 2, 0, H - 1).round())
                y1 = int(np.clip(yc + dy / 2, 0, H - 1).round())
                if x1 <= x0 or y1 <= y0:
                    continue
                mean_color = rgbs[i][y0:y1, x0:x1].reshape(-1, 3).mean(axis=0)
                rgbs[i][y0:y1, x0:x1] = (mean_color + 0.5).astype(np.uint8)
                rects.append((x0, x1, y0, y1))
            _mark_in_rects(trajs[i], rects, visibles[i], (H, W),
                           pts_cache=pts_cache, frame=i)
    return rgbs, trajs, visibles


def replace_aug(rgbs: list[np.ndarray], trajs: np.ndarray, visibles: np.ndarray,
                rng: np.random.RandomState, prob: float = 0.9,
                bounds=(2, 100), max_count: int = 20, pts_cache=None):
    """Paste random jittered patches from other frames over frames s>=1;
    points inside become invisible (``flyingthingsdataset.py:632-670``)."""
    S = len(rgbs)
    H, W = rgbs[0].shape[:2]
    src = [np.asarray(r, np.uint8) for r in rgbs]
    alt: dict[int, np.ndarray] = {}  # jittered source frames, built on demand

    def alt_frame(fr: int) -> np.ndarray:
        if fr not in alt:
            alt[fr] = color_jitter(color_jitter(src[fr], rng), rng)
        return alt[fr]

    rgbs = [np.array(r, np.uint8) for r in rgbs]  # owned copies, stay uint8
    for i in range(1, S):
        if rng.rand() < prob:
            rects = []
            for _ in range(rng.randint(1, max_count + 1)):
                xc, yc = rng.randint(0, W), rng.randint(0, H)
                dx = rng.randint(bounds[0], bounds[1])
                dy = rng.randint(bounds[0], bounds[1])
                x0 = int(np.clip(xc - dx / 2, 0, W - 1).round())
                x1 = int(np.clip(xc + dx / 2, 0, W - 1).round())
                y0 = int(np.clip(yc - dy / 2, 0, H - 1).round())
                y1 = int(np.clip(yc + dy / 2, 0, H - 1).round())
                wid, hei = x1 - x0, y1 - y0
                if wid <= 0 or hei <= 0 or hei >= H or wid >= W:
                    continue
                y00 = rng.randint(0, H - hei)
                x00 = rng.randint(0, W - wid)
                fr = rng.randint(0, S)
                rgbs[i][y0:y1, x0:x1] = alt_frame(fr)[y00:y00 + hei, x00:x00 + wid]
                rects.append((x0, x1, y0, y1))
            _mark_in_rects(trajs[i], rects, visibles[i], (H, W),
                           pts_cache=pts_cache, frame=i)
    return rgbs, trajs, visibles


def photometric_augs(rgbs, trajs, visibles, rng, eraser=True, replace=True,
                     color_prob=0.5, blur_prob=0.5):
    """Full photometric stack (``flyingthingsdataset.py:595-682``)."""
    rgbs = [np.asarray(r, np.uint8) for r in rgbs]
    pts_cache = {}  # trajs are not moved by eraser/replace: quantize once
    if eraser:
        rgbs, trajs, visibles = eraser_aug(rgbs, trajs, visibles, rng,
                                           pts_cache=pts_cache)
    if replace:
        rgbs, trajs, visibles = replace_aug(rgbs, trajs, visibles, rng,
                                            pts_cache=pts_cache)
    if rng.rand() < color_prob:
        rgbs = [color_jitter(r, rng) for r in rgbs]
    if rng.rand() < blur_prob:
        rgbs = [gaussian_blur(r, rng) for r in rgbs]
    return rgbs, trajs, visibles


def spatial_augs(rgbs, occs, masks, trajs, visibles, rng, crop_size,
                 pad_bounds=(0, 100), resize_lim=(0.25, 2.0), resize_delta=0.2,
                 max_crop_offset=100, h_flip_prob=0.5, v_flip_prob=0.5):
    """Drifting scale + drifting crop + flips (``flyingthingsdataset.py:684-846``).

    occs are padded with 255 (padding marker used for visibility bookkeeping).
    """
    S = len(rgbs)
    rgbs = [r.astype(np.float32) for r in rgbs]
    trajs = trajs.copy()

    pad_x0, pad_x1, pad_y0, pad_y1 = (rng.randint(pad_bounds[0], pad_bounds[1])
                                      for _ in range(4))
    rgbs = [np.pad(r, ((pad_y0, pad_y1), (pad_x0, pad_x1), (0, 0))) for r in rgbs]
    occs = [np.pad(o, ((pad_y0, pad_y1), (pad_x0, pad_x1)), constant_values=255)
            for o in occs]
    masks = [np.pad(m, ((pad_y0, pad_y1), (pad_x0, pad_x1))) for m in masks]
    trajs[:, :, 0] += pad_x0
    trajs[:, :, 1] += pad_y0
    H, W = rgbs[0].shape[:2]

    # drifting scale
    scale = rng.uniform(*resize_lim)
    scale_x = scale_y = scale
    sdx = sdy = 0.0
    for s in range(S):
        if s == 1:
            sdx = rng.uniform(-resize_delta, resize_delta)
            sdy = rng.uniform(-resize_delta, resize_delta)
        elif s > 1:
            sdx = sdx * 0.8 + rng.uniform(-resize_delta, resize_delta) * 0.2
            sdy = sdy * 0.8 + rng.uniform(-resize_delta, resize_delta) * 0.2
        scale_x += sdx
        scale_y += sdy
        scale_xy = (scale_x + scale_y) * 0.5
        scale_x = scale_x * 0.5 + scale_xy * 0.5
        scale_y = scale_y * 0.5 + scale_xy * 0.5
        scale_x = float(np.clip(scale_x, 0.2, 2.0))
        scale_y = float(np.clip(scale_y, 0.2, 2.0))
        H_new = max(int(H * scale_y), crop_size[0] + 10)
        W_new = max(int(W * scale_x), crop_size[1] + 10)
        sx, sy = W_new / float(W), H_new / float(H)
        rgbs[s] = resize_linear(rgbs[s], (H_new, W_new))
        occs[s] = resize_linear(occs[s], (H_new, W_new))
        masks[s] = resize_linear(masks[s], (H_new, W_new))
        trajs[s, :, 0] *= sx
        trajs[s, :, 1] *= sy

    # drifting crop centered on visible points
    ok = visibles[0, :] > 0
    if ok.any():
        mid_x = float(np.mean(trajs[0, ok, 0]))
        mid_y = float(np.mean(trajs[0, ok, 1]))
    else:
        mid_y, mid_x = crop_size[0], crop_size[1]
    x0 = int(mid_x - crop_size[1] // 2)
    y0 = int(mid_y - crop_size[0] // 2)
    off_x = off_y = 0
    for s in range(S):
        if s == 1:
            off_x = rng.randint(-max_crop_offset, max_crop_offset)
            off_y = rng.randint(-max_crop_offset, max_crop_offset)
        elif s > 1:
            off_x = int(off_x * 0.8 + rng.randint(-max_crop_offset, max_crop_offset + 1) * 0.2)
            off_y = int(off_y * 0.8 + rng.randint(-max_crop_offset, max_crop_offset + 1) * 0.2)
        x0 += off_x
        y0 += off_y
        H_new, W_new = rgbs[s].shape[:2]
        y0 = 0 if H_new == crop_size[0] else min(max(0, y0), H_new - crop_size[0] - 1)
        x0 = 0 if W_new == crop_size[1] else min(max(0, x0), W_new - crop_size[1] - 1)
        rgbs[s] = rgbs[s][y0:y0 + crop_size[0], x0:x0 + crop_size[1]]
        occs[s] = occs[s][y0:y0 + crop_size[0], x0:x0 + crop_size[1]]
        masks[s] = masks[s][y0:y0 + crop_size[0], x0:x0 + crop_size[1]]
        trajs[s, :, 0] -= x0
        trajs[s, :, 1] -= y0

    H_new, W_new = crop_size
    if rng.rand() < h_flip_prob:
        rgbs = [r[:, ::-1] for r in rgbs]
        occs = [o[:, ::-1] for o in occs]
        masks = [m[:, ::-1] for m in masks]
        trajs[:, :, 0] = W_new - trajs[:, :, 0]
    if rng.rand() < v_flip_prob:
        rgbs = [r[::-1] for r in rgbs]
        occs = [o[::-1] for o in occs]
        masks = [m[::-1] for m in masks]
        trajs[:, :, 1] = H_new - trajs[:, :, 1]
    return rgbs, occs, masks, trajs


def just_crop(rgbs, occs, masks, trajs, rng, crop_size):
    """Random crop only (``flyingthingsdataset.py:848-869``)."""
    H, W = rgbs[0].shape[:2]
    trajs = trajs.copy()
    y0 = rng.randint(0, max(H - crop_size[0], 1))
    x0 = rng.randint(0, max(W - crop_size[1], 1))
    rgbs = [r[y0:y0 + crop_size[0], x0:x0 + crop_size[1]] for r in rgbs]
    occs = [o[y0:y0 + crop_size[0], x0:x0 + crop_size[1]] for o in occs]
    masks = [m[y0:y0 + crop_size[0], x0:x0 + crop_size[1]] for m in masks]
    trajs[:, :, 0] -= x0
    trajs[:, :, 1] -= y0
    return rgbs, occs, masks, trajs
