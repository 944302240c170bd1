"""Benchmark metric definitions, matched to the reference scripts exactly
(a copy of ``pips_tpu/evals/metrics.py``, numpy on the host).

* ATE all/vis/occ — masked mean L2 error (reference ``test_on_flt.py:89-98``),
  with the per-sequence visibility relabeling "visible in >= 4 of S frames"
  (``test_on_flt.py:83``).
* BADJA PCK@0.2*sqrt(area) — fraction of visible keypoints (target frames
  s>=1) within 0.2*sqrt(segmentation area) of gt (``test_on_badja.py:141-158``).
"""

from __future__ import annotations

import numpy as np


def per_seq_vis_label(vis_g: np.ndarray, min_frames: int = 4) -> np.ndarray:
    """(B, S, N) per-frame visibility -> per-sequence label broadcast to S."""
    lab = (vis_g.sum(axis=1, keepdims=True) >= min_frames).astype(np.float32)
    return np.broadcast_to(lab, vis_g.shape).copy()


def ate_metrics(trajs_e: np.ndarray, trajs_g: np.ndarray, valids: np.ndarray,
                vis_g: np.ndarray, eps: float = 1e-6) -> dict:
    """trajs_*: (B, S, N, 2); valids/vis_g: (B, S, N). Masked-mean L2 errors."""
    ate = np.linalg.norm(trajs_e - trajs_g, axis=-1)

    def masked_mean(mask):
        return float((ate * mask).sum() / (eps + mask.sum()))

    return {
        "ate_all": masked_mean(valids),
        "ate_vis": masked_mean(valids * vis_g),
        "ate_occ": masked_mean(valids * (1.0 - vis_g)),
    }


def pck_at_sqrt_area(trajs_e: np.ndarray, trajs_g: np.ndarray,
                     visibles: np.ndarray, segs: np.ndarray,
                     ratio: float = 0.2) -> float:
    """BADJA PCK. trajs: (S, N, 2); visibles: (S, N); segs: (S, H, W).

    Target frames are s in [1, S); a visible keypoint counts as correct when
    ||e - g|| < ratio * sqrt(area(seg_s)).
    """
    S, N = visibles.shape
    accs = []
    for s1 in range(1, S):
        area = float(segs[s1].sum())
        thr = ratio * np.sqrt(area)
        for n in range(N):
            if visibles[s1, n] > 0:
                dist = float(np.linalg.norm(trajs_e[s1, n] - trajs_g[s1, n]))
                accs.append(1.0 if dist < thr else 0.0)
    if not accs:
        return float("nan")
    return float(np.mean(accs) * 100.0)
