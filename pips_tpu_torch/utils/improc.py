"""Media summaries of the train loop: a copy of the numpy parts of
``pips_tpu/utils/improc.py`` that ``train/loop.py`` uses.

``Summ_writer.summ_traj2ds_on_rgbs`` (trajectories drawn over the frames) and
``summ_rgbs`` (a frame stack), ``render_fcp_vis`` (score-map heatmaps with the
estimated and true keypoints) and ``write_gif``, with the helpers they call.
``cv2`` and ``imageio`` stay optional, as in the JAX package: without cv2 the
frames are written without the drawn trajectories, and without imageio the
GIF goes through PIL.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from pips_tpu_torch.utils.logging import MetricWriter

EPS = 1e-6


def back2color(x: np.ndarray) -> np.ndarray:
    """[-0.5, 0.5] -> uint8 [0,255]."""
    return np.clip(np.round((x + 0.5) * 255.0), 0, 255).astype(np.uint8)


def _colormap(vals: np.ndarray, cmap: str = "spring") -> np.ndarray:
    """vals in [0,1] -> (..., 3) uint8 colors via matplotlib when available."""
    try:
        import matplotlib.cm as cm
        mapper = cm.get_cmap(cmap)
    except Exception:
        try:
            from matplotlib import colormaps
            mapper = colormaps[cmap]
        except Exception:
            # fallback: simple green->red ramp
            v = np.clip(vals, 0, 1)
            return np.stack([v * 255, (1 - v) * 255, np.zeros_like(v)], -1).astype(np.uint8)
    return (np.asarray(mapper(np.clip(vals, 0, 1)))[..., :3] * 255).astype(np.uint8)


def strnum(x) -> str:
    """Compact number formatting for frame-id stamps: '%g', with the leading 0
    dropped below 1.0."""
    s = "%g" % x
    if s.startswith("0."):
        s = s[1:]
    elif s.startswith("-0."):
        s = "-" + s[2:]
    return s


def _stamp_frames(frames, frame_ids):
    """Stamp one id per frame; a length mismatch is a caller bug."""
    frames = list(frames)
    assert len(frame_ids) == len(frames), (len(frame_ids), len(frames))
    return np.stack([draw_frame_id_on_vis(f, i)
                     for f, i in zip(frames, frame_ids)])


def draw_frame_id_on_vis(vis: np.ndarray, frame_id, scale: float = 0.5,
                         left: int = 5, top: int = 20) -> np.ndarray:
    """Stamp a frame id (or any scalar) onto an image. vis: (H, W, 3) uint8
    RGB; returns a stamped copy."""
    img = np.ascontiguousarray(vis).copy()
    if cv2 is None or frame_id is None:
        return img
    cv2.putText(img, strnum(frame_id), (left, top),
                cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1)
    return img


def draw_trajs_on_rgb(rgb: np.ndarray, trajs: np.ndarray,
                      valids: Optional[np.ndarray] = None, cmap: str = "spring",
                      linewidth: int = 1, show_dots: bool = True) -> np.ndarray:
    """Rasterize full trajectories onto one frame.

    rgb: (H, W, 3) uint8; trajs: (S, N, 2) xy. Colors follow time via cmap.
    """
    img = rgb.copy()
    if cv2 is None:
        return img
    S, N, _ = trajs.shape
    colors = _colormap(np.linspace(0, 1, S), cmap)
    for n in range(N):
        if valids is not None and valids[0, n] <= 0:
            continue
        for s in range(S - 1):
            p0 = tuple(np.round(trajs[s, n]).astype(int))
            p1 = tuple(np.round(trajs[s + 1, n]).astype(int))
            cv2.line(img, p0, p1, tuple(int(c) for c in colors[s]), linewidth,
                     cv2.LINE_AA)
        if show_dots:
            p = tuple(np.round(trajs[-1, n]).astype(int))
            cv2.circle(img, p, linewidth + 1, tuple(int(c) for c in colors[-1]), -1)
    return img


def draw_trajs_on_rgbs(rgbs: np.ndarray, trajs: np.ndarray,
                       visibles: Optional[np.ndarray] = None,
                       cmap: str = "spring", linewidth: int = 1) -> np.ndarray:
    """Per-frame overlay: history up to s drawn on frame s.

    rgbs: (S, H, W, 3) uint8; trajs: (S, N, 2). Returns (S, H, W, 3) uint8.
    """
    S = rgbs.shape[0]
    out = []
    for s in range(S):
        img = draw_trajs_on_rgb(rgbs[s], trajs[: s + 1], cmap=cmap,
                                linewidth=linewidth, show_dots=False)
        if cv2 is not None:
            N = trajs.shape[1]
            colors = _colormap(np.full(N, s / max(S - 1, 1)), cmap)
            for n in range(N):
                if visibles is None or visibles[s, n] > 0.5:
                    p = tuple(np.round(trajs[s, n]).astype(int))
                    cv2.circle(img, p, linewidth + 1, tuple(int(c) for c in colors[n]), -1)
        out.append(img)
    return np.stack(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int = 8) -> None:
    """frames: list of (H, W, 3) uint8."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
        imageio.mimsave(path, list(frames), duration=1.0 / fps, loop=0)
    except Exception:
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)


def oned_to_rgb(x: np.ndarray, norm: bool = True) -> np.ndarray:
    """(H, W) scalar map -> (H, W, 3) uint8 heatmap."""
    if norm:
        x = (x - x.min()) / (EPS + x.max() - x.min())
    return _colormap(x, "viridis")


class Summ_writer:
    """Frequency-gated summary facade.

    ``save_this`` is true when global_step hits log_freq. Media goes to
    ``<log_dir>/media/...``.
    """

    def __init__(self, writer: MetricWriter, global_step: int, log_freq: int = 100,
                 fps: int = 8):
        self.writer = writer
        self.global_step = global_step
        self.log_freq = max(log_freq, 1)
        self.fps = fps
        self.save_this = (global_step % self.log_freq == 0)
        self.media_dir = os.path.join(writer.log_dir, "media")

    def _media_path(self, name: str, ext: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.media_dir, f"{self.global_step:08d}_{safe}.{ext}")

    def summ_rgbs(self, name: str, rgbs: Sequence[np.ndarray],
                  only_return: bool = False, frame_ids=None):
        frames = [r if r.dtype == np.uint8 else back2color(r) for r in rgbs]
        if frame_ids is not None:
            frames = list(_stamp_frames(frames, frame_ids))
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), frames, fps=self.fps)
        return np.stack(frames)

    def summ_traj2ds_on_rgbs(self, name: str, trajs: np.ndarray, rgbs: np.ndarray,
                             visibles: Optional[np.ndarray] = None,
                             cmap: str = "spring", linewidth: int = 1,
                             only_return: bool = False, frame_ids=None):
        frames = rgbs if rgbs.dtype == np.uint8 else back2color(rgbs)
        frames = draw_trajs_on_rgbs(frames, trajs, visibles=visibles, cmap=cmap,
                                    linewidth=linewidth)
        if frame_ids is not None:
            frames = _stamp_frames(frames, frame_ids)
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), list(frames), fps=self.fps)
        return frames


def draw_circles_at_xy(xys: np.ndarray, H: int, W: int, sigma: float = 1.0) -> np.ndarray:
    """Gaussian blobs at xy positions: (N, 2) -> (N, H, W) float in [0, 1]."""
    yy = np.arange(H, dtype=np.float32)[:, None]
    xx = np.arange(W, dtype=np.float32)[None, :]
    out = np.empty((len(xys), H, W), np.float32)
    for n, (x, y) in enumerate(np.asarray(xys, np.float32)):
        d2 = (yy - y) ** 2 + (xx - x) ** 2
        out[n] = np.exp(-d2 / (2.0 * sigma ** 2))
    return out


def render_fcp_vis(fcps: np.ndarray, coords: np.ndarray,
                   trajs_g: Optional[np.ndarray] = None,
                   stride: int = 8) -> np.ndarray:
    """Per-iteration score-map heatmaps with estimated (and true) keypoints
    overlaid, from ``PipsOutput.fcps`` after the forward.

    fcps: (S, I, H8, W8) score maps for one point; coords: (I, S, 2) pixel
    coords per iteration. Returns frames (S*I, H8, W8, 3) uint8.
    """
    S, I, H8, W8 = fcps.shape
    frames = []
    for s in range(S):
        for i in range(I):
            heat = oned_to_rgb(fcps[s, i])
            kp = draw_circles_at_xy(coords[i, s][None] / stride, H8, W8, sigma=1.0)[0]
            img = heat.astype(np.float32)
            img[..., 0] = np.clip(img[..., 0] + kp * 255, 0, 255)
            if trajs_g is not None:
                kg = draw_circles_at_xy(trajs_g[s][None] / stride, H8, W8, sigma=1.0)[0]
                img[..., 1] = np.clip(img[..., 1] + kg * 255, 0, 255)
            frames.append(img.astype(np.uint8))
    return np.stack(frames)
