"""Visualization and media summaries (a copy of ``pips_tpu/utils/improc.py``,
numpy and cv2 on the host; capability parity: reference
``utils/improc.py:350-972``).

Trajectory rasterization (cv2 lines and circles with matplotlib colormaps),
PCA feature visualization, GIF export, and a ``Summ_writer`` facade with the
reference's ``save_this`` and scalar-frequency gating, backed by the JSONL
``MetricWriter`` plus GIF/PNG files on disk. ``cv2`` and ``imageio`` stay
optional, as in the JAX package: without cv2 the frames are written without
the drawn trajectories and no PNG is written; without imageio the GIF goes
through PIL. ``flow2color`` and ``Summ_writer.summ_flow(s)`` draw the RAFT
baseline's flow fields."""

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
SCALAR_FREQ = 10  # Summ_writer's default steps between scalar summaries, as JAX's


def preprocess_color(rgb: np.ndarray) -> np.ndarray:
    """uint8-range [0,255] -> [-0.5, 0.5] float (reference convention)."""
    return rgb.astype(np.float32) / 255.0 - 0.5


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
    """Compact number formatting for frame-id stamps (reference
    ``utils/basic.py:14-19``): '%g', with the leading 0 dropped below 1.0.
    Divergence from the reference: it strips the sign off negatives too
    (``-0.5 -> '.5'``); here only the leading zero is dropped."""
    s = "%g" % x
    if s.startswith("0."):
        s = s[1:]
    elif s.startswith("-0."):
        s = "-" + s[2:]
    return s


def _stamp_frames(frames, frame_ids):
    """Stamp one id per frame; a length mismatch is a caller bug (the
    reference asserts len(frame_ids)==S too) — zip would silently truncate."""
    frames = list(frames)
    assert len(frame_ids) == len(frames), (len(frame_ids), len(frames))
    return np.stack([draw_frame_id_on_vis(f, i)
                     for f, i in zip(frames, frame_ids)])


def draw_frame_id_on_vis(vis: np.ndarray, frame_id, scale: float = 0.5,
                         left: int = 5, top: int = 20) -> np.ndarray:
    """Stamp a frame id (or any scalar, e.g. an ATE value) onto an image —
    reference ``utils/improc.py:294-314``, used by every eval script to label
    trajectory overlays with the metric value. vis: (H, W, 3) uint8 RGB;
    returns a stamped copy."""
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

    rgb: (H, W, 3) uint8; trajs: (S, N, 2) xy. Colors follow time via cmap
    (reference ``utils/improc.py:summ_traj2ds_on_rgb`` behavior).
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


def pca_feat_vis(feat: np.ndarray) -> np.ndarray:
    """(H, W, C) feature map -> (H, W, 3) uint8 PCA visualization
    (reference ``utils/improc.py:571-616`` capability)."""
    H, W, C = feat.shape
    flat = feat.reshape(-1, C).astype(np.float64)
    flat = flat - flat.mean(axis=0)
    # top-3 principal directions via SVD on (C, C) covariance
    cov = flat.T @ flat / max(flat.shape[0] - 1, 1)
    _, vecs = np.linalg.eigh(cov)
    proj = flat @ vecs[:, -3:]  # (HW, 3)
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    proj = (proj - lo) / (EPS + hi - lo)
    return (proj.reshape(H, W, 3) * 255).astype(np.uint8)


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


def flow2color(flow: np.ndarray, clip: float = 50.0) -> np.ndarray:
    """Optical-flow color wheel (reference ``utils/improc.py:433-470``).

    flow: (..., H, W, 2) xy displacement -> (..., H, W, 3) uint8. Hue encodes
    direction (atan2), value encodes clipped magnitude, saturation fixed at
    0.75. ``clip > 0`` normalizes by the clip radius; ``clip == 0`` uses the
    per-image perceived max (mean + 2*std of |flow|, floored at 1).
    """
    f = np.asarray(flow, np.float32)
    if clip:
        f = np.clip(f, -clip, clip) / clip
    else:
        mag = np.abs(f)
        axes = tuple(range(f.ndim - 3, f.ndim))  # (H, W, 2)
        fmax = mag.mean(axis=axes) + 2.0 * mag.std(axis=axes) + 1e-10
        fmax_c = np.maximum(fmax, 1.0)
        fmax = fmax.reshape(fmax.shape + (1, 1, 1))
        fmax_c = fmax_c.reshape(fmax_c.shape + (1, 1, 1))
        f = np.clip(f, -fmax, fmax) / fmax_c
    radius = np.clip(np.sqrt(np.sum(f ** 2, axis=-1)), 0.0, 1.0)
    angle = np.arctan2(f[..., 1], f[..., 0]) / np.pi  # [-1, 1]
    hue = np.clip((angle + 1.0) / 2.0, 0.0, 1.0)
    sat = np.full_like(hue, 0.75)
    val = radius
    # HSV -> RGB (vectorized standard conversion, h in [0,1))
    h6 = np.minimum(hue, 1.0 - 1e-7) * 6.0
    i = np.floor(h6).astype(np.int32)
    ffrac = h6 - i
    p = val * (1.0 - sat)
    q = val * (1.0 - sat * ffrac)
    t = val * (1.0 - sat * (1.0 - ffrac))
    r = np.choose(i % 6, [val, q, p, p, t, val])
    g = np.choose(i % 6, [t, val, val, q, p, p])
    b = np.choose(i % 6, [p, p, t, val, val, q])
    rgb = np.stack([r, g, b], axis=-1)
    return (rgb * 255.0).astype(np.uint8)


def oned_to_rgb(x: np.ndarray, norm: bool = True) -> np.ndarray:
    """(H, W) scalar map -> (H, W, 3) uint8 heatmap."""
    if norm:
        x = (x - x.min()) / (EPS + x.max() - x.min())
    return _colormap(x, "viridis")


class Summ_writer:
    """Frequency-gated summary facade (reference ``utils/improc.py:350-440``).

    ``save_this`` is true when global_step hits log_freq; scalars use the
    finer scalar_freq. Media goes to ``<log_dir>/media/...``; scalars to the
    MetricWriter (JSONL + optional tensorboard). ``just_gif`` is kept and
    unused, as in the JAX writer.
    """

    def __init__(self, writer: MetricWriter, global_step: int, log_freq: int = 100,
                 fps: int = 8, scalar_freq: int = SCALAR_FREQ, just_gif: bool = True):
        self.writer = writer
        self.global_step = global_step
        self.log_freq = max(log_freq, 1)
        self.fps = fps
        self.scalar_freq = max(scalar_freq, 1)
        self.just_gif = just_gif
        self.save_this = (global_step % self.log_freq == 0)
        self.media_dir = os.path.join(writer.log_dir, "media")

    def _media_path(self, name: str, ext: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.media_dir, f"{self.global_step:08d}_{safe}.{ext}")

    def summ_scalar(self, name: str, value) -> None:
        if self.global_step % self.scalar_freq == 0:
            self.writer.scalars(self.global_step, {name: float(value)})

    def summ_rgb(self, name: str, rgb: np.ndarray, only_return: bool = False,
                 frame_id=None):
        """rgb: (H, W, 3) float [-0.5,0.5] or uint8. ``frame_id`` stamps the
        value top-left (reference passes e.g. the ATE here)."""
        img = rgb if rgb.dtype == np.uint8 else back2color(rgb)
        if frame_id is not None:
            img = draw_frame_id_on_vis(img, frame_id)
        if not only_return and self.save_this and cv2 is not None:
            path = self._media_path(name, "png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cv2.imwrite(path, img[..., ::-1])
        return img

    def summ_rgbs(self, name: str, rgbs: Sequence[np.ndarray],
                  only_return: bool = False, frame_ids=None):
        frames = [r if r.dtype == np.uint8 else back2color(r) for r in rgbs]
        if frame_ids is not None:
            frames = list(_stamp_frames(frames, frame_ids))
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), frames, fps=self.fps)
        return np.stack(frames)

    def summ_oned(self, name: str, x: np.ndarray, norm: bool = True,
                  only_return: bool = False, frame_id=None):
        img = oned_to_rgb(x, norm=norm)
        return self.summ_rgb(name, img, only_return=only_return,
                             frame_id=frame_id)

    def summ_oneds(self, name: str, xs: Sequence[np.ndarray], norm: bool = True,
                   only_return: bool = False, frame_ids=None):
        frames = [oned_to_rgb(x, norm=norm) for x in xs]
        if frame_ids is not None:
            frames = list(_stamp_frames(frames, frame_ids))
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), frames, fps=self.fps)
        return np.stack(frames)

    def summ_feat(self, name: str, feat: np.ndarray, only_return: bool = False,
                  frame_id=None):
        return self.summ_rgb(name, pca_feat_vis(feat), only_return=only_return,
                             frame_id=frame_id)

    def summ_feats(self, name: str, feats: Sequence[np.ndarray],
                   only_return: bool = False):
        frames = [pca_feat_vis(f) for f in feats]
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), frames, fps=self.fps)
        return np.stack(frames)

    def summ_flow(self, name: str, flow: np.ndarray, clip: float = 0.0,
                  only_return: bool = False, frame_id=None):
        """flow: (H, W, 2) xy displacement."""
        return self.summ_rgb(name, flow2color(flow, clip=clip),
                             only_return=only_return, frame_id=frame_id)

    def summ_flows(self, name: str, flows: Sequence[np.ndarray],
                   clip: float = 0.0, only_return: bool = False):
        frames = [flow2color(f, clip=clip) for f in flows]
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), frames, fps=self.fps)
        return np.stack(frames)

    def summ_traj2ds_on_rgb(self, name: str, trajs: np.ndarray, rgb: np.ndarray,
                            valids: Optional[np.ndarray] = None,
                            cmap: str = "spring", linewidth: int = 1,
                            only_return: bool = False, frame_id=None):
        img = rgb if rgb.dtype == np.uint8 else back2color(rgb)
        img = draw_trajs_on_rgb(img, trajs, valids=valids, cmap=cmap,
                                linewidth=linewidth)
        return self.summ_rgb(name, img, only_return=only_return,
                             frame_id=frame_id)

    def summ_soft_seg_thr(self, name: str, seg: np.ndarray,
                          label_colors: Optional[np.ndarray] = None,
                          thr: float = 0.5, only_return: bool = False):
        """Colorized thresholded soft segmentation.

        seg: (N, H, W) soft masks in [0, 1]; label_colors: (N, 3) uint8
        (defaults to a colormap spread). Per pixel, labels whose mask clears
        ``thr`` contribute their color scaled by mask strength; overlaps
        max-composite. Returns (H, W, 3) uint8.

        Capability: the reference calls ``sw.summ_soft_seg_thr`` for BADJA
        keypoint rendering (``test_on_badja.py:133,253,268``) but never ships
        the method (the calls sit in dead ``if False:`` blocks) — behavior
        here is reconstructed from those call sites.
        """
        seg = np.asarray(seg, np.float32)
        N, H, W = seg.shape
        if label_colors is None:
            label_colors = _colormap(np.linspace(0, 1, max(N, 2))[:N], "spring")
        label_colors = np.asarray(label_colors, np.float32)  # (N, 3)
        m = np.where(seg >= thr, seg, 0.0)                   # (N, H, W)
        img = np.max(m[..., None] * label_colors[:, None, None, :], axis=0)
        img = np.clip(img, 0, 255).astype(np.uint8)
        return self.summ_rgb(name, img, only_return=only_return)

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

    def summ_traj2ds_on_rgbs2(self, name: str, trajs: np.ndarray,
                              visibles: np.ndarray, rgbs: np.ndarray,
                              valids: Optional[np.ndarray] = None,
                              cmap: str = "spring", linewidth: int = 1,
                              only_return: bool = False, frame_ids=None):
        """Visibility-coded trajectory overlay (reference
        ``utils/improc.py:701-759``): lines for every all-frames-valid point,
        filled/open circles by per-frame visibility. trajs (S, N, 2),
        visibles/valids (S, N), rgbs (S, H, W, 3)."""
        if valids is not None:
            keep = np.asarray(valids).min(axis=0) > 0  # valid in ALL frames
            trajs, visibles = trajs[:, keep], visibles[:, keep]
        frames = rgbs if rgbs.dtype == np.uint8 else back2color(rgbs)
        frames = draw_trajs_on_rgbs2(frames, trajs, visibles, cmap=cmap,
                                     linewidth=linewidth)
        if frame_ids is not None:
            frames = _stamp_frames(frames, frame_ids)
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), list(frames), fps=self.fps)
        return frames

    def summ_pts_on_rgbs(self, name: str, trajs: np.ndarray, rgbs: np.ndarray,
                         valids: Optional[np.ndarray] = None,
                         cmap: str = "coolwarm", linewidth: int = 1,
                         only_return: bool = False, frame_ids=None):
        """Per-frame point markers, no trajectory history (reference
        ``utils/improc.py:762-817``). trajs (S, N, 2), rgbs (S, H, W, 3),
        valids (S, N): invalid points are not drawn on that frame."""
        frames = (rgbs if rgbs.dtype == np.uint8 else back2color(rgbs)).copy()
        S, N = trajs.shape[:2]
        colors = _colormap(np.linspace(0, 1, max(N, 2))[:N], cmap)
        if cv2 is not None:
            for s in range(S):
                for n in range(N):
                    if valids is not None and valids[s, n] <= 0:
                        continue
                    p = tuple(np.round(trajs[s, n]).astype(int))
                    cv2.circle(frames[s], p, linewidth + 1,
                               tuple(int(c) for c in colors[n]), -1)
        if frame_ids is not None:
            frames = _stamp_frames(frames, frame_ids)
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), list(frames), fps=self.fps)
        return frames

    def summ_gif(self, name: str, frames: np.ndarray, only_return: bool = False):
        """Write a (S, H, W, 3) frame stack as a gif (reference summ_gif)."""
        frames = frames if frames.dtype == np.uint8 else back2color(frames)
        if not only_return and self.save_this:
            write_gif(self._media_path(name, "gif"), list(frames), fps=self.fps)
        return frames


def draw_circles_at_xy(xys: np.ndarray, H: int, W: int, sigma: float = 1.0) -> np.ndarray:
    """Gaussian blobs at xy positions: (N, 2) -> (N, H, W) float in [0, 1]
    (reference ``utils/improc.py:draw_circles_at_xy`` capability)."""
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
    """Per-iteration score-map heatmaps with estimated (and gt) keypoints
    overlaid — the host-side analog of the visualization the reference runs
    INSIDE ``Pips.forward`` (``nets/pips.py:481-497,566-598``); here it
    consumes ``PipsOutput.fcps`` after the fact, keeping the jitted forward
    visualization-free.

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


def colormap_2d(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """2D position colormap (the reference's bremm.png role,
    ``utils/improc.py:316-335``): map (u, v) in [0,1]^2 to RGB by bilinear
    corner interpolation (procedural stand-in for the bremm texture)."""
    u = np.clip(np.asarray(u, np.float32), 0, 1)[..., None]
    v = np.clip(np.asarray(v, np.float32), 0, 1)[..., None]
    c00 = np.array([0, 80, 255], np.float32)      # blue
    c01 = np.array([0, 255, 120], np.float32)     # green
    c10 = np.array([255, 70, 50], np.float32)     # red
    c11 = np.array([255, 230, 0], np.float32)     # yellow
    rgb = ((1 - u) * (1 - v) * c00 + (1 - u) * v * c01
           + u * (1 - v) * c10 + u * v * c11)
    return rgb.astype(np.uint8)


def seq2color(seq: np.ndarray, colormap: str = "spring") -> np.ndarray:
    """Collapse a temporal stack of heatmaps to one RGB image with color
    encoding time (reference ``utils/improc.py:seq2color`` capability).

    seq: (S, H, W) nonneg -> (H, W, 3) uint8: per pixel, the argmax-time's
    color scaled by intensity.
    """
    S, H, W = seq.shape
    colors = _colormap(np.linspace(0, 1, S), colormap).astype(np.float32)  # (S,3)
    t = np.argmax(seq, axis=0)            # (H, W)
    mag = np.clip(seq.max(axis=0), 0, 1)  # (H, W)
    img = colors[t] * mag[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_trajs_on_rgbs2(rgbs: np.ndarray, trajs: np.ndarray, visibles: np.ndarray,
                        cmap: str = "spring", linewidth: int = 1) -> np.ndarray:
    """Visibility-coded per-frame overlay (reference ``summ_traj2ds_on_rgbs2``):
    filled markers when visible, thin open rings when occluded.

    rgbs: (S, H, W, 3) uint8; trajs: (S, N, 2); visibles: (S, N) in [0, 1].
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
                p = tuple(np.round(trajs[s, n]).astype(int))
                col = tuple(int(c) for c in colors[n])
                if visibles[s, n] > 0.5:
                    cv2.circle(img, p, linewidth + 1, col, -1)
                else:
                    cv2.circle(img, p, linewidth + 2, col, 1)
        out.append(img)
    return np.stack(out)
