"""Single-window inference (counterpart of ``pips_tpu/inference/window.py``).

One eval-mode forward over an S-frame window per call; no mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pips_tpu_torch.models.pips import Pips, resolve_device
from pips_tpu_torch.ops.grids import gridcloud2d


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
    """Eval-mode forward over one S-frame window of ``model`` on ``device``
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, model: Pips, iters: int = 6, corr_mode: str = "onehot",
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.iters = iters
        self.corr_mode = corr_mode

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def __call__(self, xys, rgbs):
        """xys: (B, N, 2); rgbs: (B, S, H, W, 3) in [0, 255].
        Returns numpy (trajs (B, S, N, 2), vis logits (B, S, N))."""
        out = self.model(self._in(xys), self._in(rgbs), iters=self.iters,
                         is_train=False, corr_mode=self.corr_mode)
        return (out.coord_predictions[-1].float().cpu().numpy(),
                out.vis_e.float().cpu().numpy())

    @torch.inference_mode()
    def encode(self, rgbs) -> torch.Tensor:
        return self.model.encode(self._in(rgbs))

    @torch.inference_mode()
    def track(self, fmaps: torch.Tensor, xys, feat_init: Optional[torch.Tensor] = None):
        """Returns (coords (B, S, N, 2), vis logits (B, S, N), ffeat (B, N, C))
        as tensors on the tracker's device."""
        out = self.model.track(fmaps, self._in(xys), feat_init=feat_init, iters=self.iters,
                               is_train=False, corr_mode=self.corr_mode)
        return out.coord_predictions[-1], out.vis_e, out.ffeat
