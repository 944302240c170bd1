"""Occluder extraction for FlyingThings++ (counterpart of
``pips_tpu/datagen/occluders.py``; capability parity: reference
``make_occlusions.py:66-295``).

For each object id in a clip: accept it as a paste-able occluder when
(1) its mask is near-convex on every frame (IoU vs convex-hull fill >= 0.98),
(2) its mask is consistent with forward/backward flow transport (>= 0.95),
then chain+filter its pixels' trajectories. Emits {id: trajs} dicts saved as
``occluder_at_<k>.npy``.
"""

from __future__ import annotations

import numpy as np

from pips_tpu_torch.datagen.trajs import filter_trajs

MIN_SIZE = 32 * 32


def flood_fill_hull(image: np.ndarray):
    """Convex fill of a binary mask via Delaunay of its hull points
    (reference ``make_occlusions.py:56-64``)."""
    import scipy.spatial

    points = np.transpose(np.where(image))
    hull = scipy.spatial.ConvexHull(points)
    deln = scipy.spatial.Delaunay(points[hull.vertices])
    idx = np.stack(np.indices(image.shape), axis=-1)
    out_idx = np.nonzero(deln.find_simplex(idx) + 1)
    out = np.zeros(image.shape)
    out[out_idx] = 1
    return out, hull


def consider_id(id_: float, masks: np.ndarray, flows_f: np.ndarray,
                flows_b: np.ndarray, fw_thr: float = 0.95, bw_thr: float = 0.95,
                hu_thr: float = 0.98):
    """masks: (S, H, W) object-index maps; flows: (S-1, H, W, 2).
    Returns trajs (S, N, 2) float16 for this id, or None if rejected."""
    S, H, W = masks.shape
    singles = (masks == id_).astype(np.float32)

    sums = singles.reshape(S, -1).sum(1)
    nonzero = sums[sums > 0]
    if len(nonzero) < 3 or nonzero.mean() < MIN_SIZE * 2:
        return None

    # near-convexity per frame
    for s in range(S):
        if sums[s] > 4:
            try:
                close, _ = flood_fill_hull(singles[s].astype(np.int64))
            except Exception:
                return None
            inter = (close * singles[s]).sum()
            union = np.clip(close + singles[s], 0, 1).sum()
            if inter / max(union, 1.0) < hu_thr:
                return None

    # forward flow-mask consistency
    for s in range(S - 1):
        if sums[s] > MIN_SIZE:
            ys, xs = np.where(singles[s] > 0)
            delta = flows_f[s, ys, xs]
            xs_ = np.round(xs + delta[:, 0]).astype(np.int64)
            ys_ = np.round(ys + delta[:, 1]).astype(np.int64)
            ok = (xs_ >= 0) & (xs_ <= W - 1) & (ys_ >= 0) & (ys_ <= H - 1)
            if ok.sum() > MIN_SIZE:
                if singles[s + 1][ys_[ok], xs_[ok]].mean() < fw_thr:
                    return None

    # backward flow-mask consistency
    for s in range(S - 1):
        if sums[s] > MIN_SIZE:
            ys, xs = np.where(singles[s + 1] > 0)
            delta = flows_b[s, ys, xs]
            xs_ = np.round(xs + delta[:, 0]).astype(np.int64)
            ys_ = np.round(ys + delta[:, 1]).astype(np.int64)
            ok = (xs_ >= 0) & (xs_ <= W - 1) & (ys_ >= 0) & (ys_ <= H - 1)
            if ok.sum() > MIN_SIZE:
                if singles[s][ys_[ok], xs_[ok]].mean() < bw_thr:
                    return None

    # chain this id's pixel trajectories from frame 0
    ys, xs = np.where(singles[0] > 0)
    if len(xs) == 0:
        return np.zeros((S, 0, 2), np.float16)
    coord = np.stack([xs, ys], axis=1).astype(np.float32)
    coords = [coord]
    for s in range(S - 1):
        x_ = np.clip(np.round(coord[:, 0]).astype(np.int64), 0, W - 1)
        y_ = np.clip(np.round(coord[:, 1]).astype(np.int64), 0, H - 1)
        coord = coord + flows_f[s, y_, x_]
        coords.append(coord)
    trajs = np.stack(coords, axis=0)
    trajs = filter_trajs(trajs, masks, flows_f, flows_b)
    return trajs.astype(np.float16)


def extract_occluders_for_clip(masks: np.ndarray, flows_f: np.ndarray,
                               flows_b: np.ndarray) -> dict:
    """All accepted ids for a clip: {id_str: trajs} (``occluder_at_k.npy`` payload)."""
    out = {}
    for id_ in np.unique(masks):
        trajs = consider_id(id_, masks, flows_f, flows_b)
        if trajs is not None:
            out[f"{int(id_)}"] = trajs
    return out
