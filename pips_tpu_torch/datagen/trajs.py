"""Trajectory generation by forward-flow chaining + filtering (counterpart of
``pips_tpu/datagen/trajs.py``).

Capability parity: reference ``make_trajs.py:47-204`` + ``filter_trajs.py:4-47``.
All-vectorized numpy (the reference used torch-on-GPU per-pixel ops); runs
offline on host.
"""

from __future__ import annotations

import numpy as np


def _sample_border(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Border-replicating bilinear point sample on host.

    img: (H, W, C); x, y: (N,). Matches ``pips_tpu_torch.ops.samp.bilinear_sample2d``
    semantics (weights from unclamped coords, indices clamped).
    """
    H, W, C = img.shape
    x0f, y0f = np.floor(x), np.floor(y)
    x0 = np.clip(x0f.astype(np.int64), 0, W - 1)
    x1 = np.clip(x0f.astype(np.int64) + 1, 0, W - 1)
    y0 = np.clip(y0f.astype(np.int64), 0, H - 1)
    y1 = np.clip(y0f.astype(np.int64) + 1, 0, H - 1)
    wx = x - x0f
    wy = y - y0f
    out = ((1 - wx) * (1 - wy))[:, None] * img[y0, x0] \
        + (wx * (1 - wy))[:, None] * img[y0, x1] \
        + ((1 - wx) * wy)[:, None] * img[y1, x0] \
        + (wx * wy)[:, None] * img[y1, x1]
    return out


def chain_flow_trajs(flows_f: np.ndarray) -> np.ndarray:
    """Chain forward flow from every pixel of frame 0.

    flows_f: (S-1, H, W, 2). Returns trajs (S, H*W, 2), xy.
    Flow is sampled at the *rounded* current position
    (reference ``make_trajs.py:113-118``).
    """
    Sm1, H, W, _ = flows_f.shape
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    coord = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)  # (N, 2)
    coords = [coord]
    for s in range(Sm1):
        delta = _sample_border(flows_f[s], np.round(coord[:, 0]), np.round(coord[:, 1]))
        coord = coord + delta
        coords.append(coord)
    return np.stack(coords, axis=0)


def filter_trajs(trajs: np.ndarray, masks: np.ndarray, flows_f: np.ndarray,
                 flows_b: np.ndarray, fb_thresh: float = 0.5) -> np.ndarray:
    """Keep trajectories that (reference ``filter_trajs.py:4-47``):
    1) stay in-bounds (rounded) over all S frames;
    2) remain on the same object id across a full 3x3 neighborhood;
    3) pass forward-backward flow consistency ||ff+bf|| < 0.5 px.

    trajs: (S, N, 2); masks: (S, H, W); flows: (S-1, H, W, 2).
    Returns the surviving (S, N', 2).
    """
    S, N, _ = trajs.shape
    H, W = masks.shape[1:3]

    r = np.round(trajs)
    inb = ((r[..., 0].min(0) >= 0) & (r[..., 0].max(0) <= W - 1)
           & (r[..., 1].min(0) >= 0) & (r[..., 1].max(0) <= H - 1))
    trajs = trajs[:, inb]

    masks3 = masks[..., None]
    id0 = _sample_border(masks3[0], np.round(trajs[0, :, 0]), np.round(trajs[0, :, 1]))[:, 0]
    ok = np.ones_like(id0, bool)
    for s in range(S):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                idi = _sample_border(masks3[s], np.round(trajs[s, :, 0]) + dx,
                                     np.round(trajs[s, :, 1]) + dy)[:, 0]
                ok &= idi == id0
    trajs = trajs[:, ok]

    fb_ok = np.ones(trajs.shape[1], bool)
    for s in range(S - 1):
        ff = _sample_border(flows_f[s], np.round(trajs[s, :, 0]), np.round(trajs[s, :, 1]))
        bf = _sample_border(flows_b[s], np.round(trajs[s + 1, :, 0]),
                            np.round(trajs[s + 1, :, 1]))
        fb_ok &= np.linalg.norm(ff + bf, axis=1) < fb_thresh
    return trajs[:, fb_ok]


def make_trajs_for_clip(flows_f: np.ndarray, flows_b: np.ndarray,
                        masks: np.ndarray, min_trajs: int = 256):
    """Full per-clip pipeline: chain + filter; returns float16 trajs or None
    when fewer than ``min_trajs`` survive (reference ``make_trajs.py:147-155``)."""
    trajs = chain_flow_trajs(flows_f)
    trajs = filter_trajs(trajs, masks, flows_f, flows_b)
    if trajs.shape[1] < min_trajs:
        return None
    return trajs.astype(np.float16)
