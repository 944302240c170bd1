"""Single-window inference (counterpart of ``pips_tpu/inference/window.py``).

One eval-mode forward over an S-frame window per call; with a mesh, each
process tracks its slice of the points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pips_tpu_torch.models.pips import CORR_MODES, Pips, resolve_device
from pips_tpu_torch.models.pips2 import Pips2
from pips_tpu_torch.ops.grids import gridcloud2d
from pips_tpu_torch.parallel.mesh import gather_points, point_shard
from pips_tpu_torch.utils.spans import span


def grid_queries(H: int, W: int, grid_y: int = 16, grid_x: int = 16,
                 margin: int = 8) -> np.ndarray:
    """(1, grid_y*grid_x, 2) xy query grid with a pixel margin."""
    ys = np.linspace(margin, H - margin, grid_y)
    xs = np.linspace(margin, W - margin, grid_x)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)[None].astype(np.float32)


def dense_queries(H: int, W: int, stride: int = 8) -> np.ndarray:
    """Every ``stride``-th pixel: (1, (H/stride)*(W/stride), 2) xy."""
    return gridcloud2d(1, H // stride, W // stride).numpy() * stride


class WindowTracker:
    """Eval-mode forward over one S-frame window of ``model`` (a ``Pips``, or a
    ``Pips2`` at any S) on ``device`` (CUDA unless the caller asks for the CPU).

    ``corr_mode`` is one of ``models.pips.CORR_MODES``; ``"pallas"`` runs the
    CUDA corr kernel on the card. ``use_fused_corr`` is the JAX package's older
    switch: when given, True means ``"fused"`` and False ``"full"``.

    With a ``mesh`` (``parallel.make_mesh``; every process of the group calls
    the tracker alike) each process tracks its slice of the points through
    the whole window, the point axis padded to a multiple of the mesh's size
    by repeating the last point, and every process gets all the points'
    results; ``encode`` runs whole on each process. The points are
    independent, so the results are the unsplit tracker's.
    """

    def __init__(self, model: Pips | Pips2, iters: int = 6, corr_mode: str = "onehot",
                 use_fused_corr: Optional[bool] = None, device="cuda", mesh=None):
        if use_fused_corr is not None:
            corr_mode = "fused" if use_fused_corr else "full"
        if corr_mode not in CORR_MODES:
            raise ValueError(f"corr_mode must be one of {CORR_MODES}, got {corr_mode!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.iters = iters
        self.corr_mode = corr_mode
        self.mesh = mesh

    def _split(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """This process's share of the point axis (1) of x, and the point count."""
        if self.mesh is None:
            return x, x.shape[1]
        return point_shard(x, self.mesh, dim=1)

    def _join(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        return x if self.mesh is None else gather_points(x, self.mesh, dim, n)

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def __call__(self, xys, rgbs):
        """xys: (B, N, 2); rgbs: (B, S, H, W, 3) in [0, 255].
        Returns numpy (trajs (B, S, N, 2), vis logits (B, S, N))."""
        with span("window"):
            with span("window.input"):
                xys, n = self._split(self._in(xys))
                rgbs = self._in(rgbs)
            out = self.model(xys, rgbs, iters=self.iters, is_train=False,
                             corr_mode=self.corr_mode)
            return (self._join(out.coord_predictions[-1], 2, n).float().cpu().numpy(),
                    self._join(out.vis_e, 2, n).float().cpu().numpy())

    @torch.inference_mode()
    def encode(self, rgbs) -> torch.Tensor:
        return self.model.encode(self._in(rgbs))

    @torch.inference_mode()
    def track(self, fmaps, xys, feat_init=None):
        """fmaps: (B, S, H8, W8, C), a tensor or numpy array, kept in its dtype;
        xys: (B, N, 2); feat_init: (B, N, C), taken as f32. Arrays and tensors
        elsewhere are moved to the tracker's device. Returns (coords
        (B, S, N, 2), vis logits (B, S, N), ffeat (B, N, C)) as tensors on
        the tracker's device."""
        if not isinstance(fmaps, torch.Tensor):
            a = np.array(fmaps)  # a writable copy, in its dtype
            # numpy has no bf16 of its own: ml_dtypes' bfloat16 goes over as its bits
            fmaps = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                     if a.dtype.name == "bfloat16" else torch.from_numpy(a))
        fmaps = fmaps.to(self.device)
        xys, n = self._split(self._in(xys))
        if feat_init is not None:
            feat_init = self._split(self._in(feat_init))[0]
        out = self.model.track(fmaps, xys, feat_init=feat_init, iters=self.iters,
                               is_train=False, corr_mode=self.corr_mode)
        return (self._join(out.coord_predictions[-1], 2, n), self._join(out.vis_e, 2, n),
                self._join(out.ffeat, 1, n))
