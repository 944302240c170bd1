"""Align-corners bilinear resize and 2x2 average pooling
(counterpart of ``pips_tpu/ops/resize.py``).

The resize is two small matmuls, out = A_y @ img @ A_x^T, with the
interpolation matrices cast to the image's dtype as the JAX version does, so
bf16 rounds the same way. It works on the last two axes (NCHW for the
encoder); the JAX version is channel-last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners linear interpolation matrix."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        A[:, 0] = 1.0
        return A
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    j0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    w = pos - j0
    rows = np.arange(n_out)
    A[rows, j0] = (1.0 - w).astype(np.float32)
    A[rows, j0 + 1] = w.astype(np.float32)
    return A


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W) -> (..., H_out, W_out), align-corners bilinear."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(out_hw):
        return x
    Ay = torch.from_numpy(_interp_matrix(H, out_hw[0])).to(x.device, x.dtype)
    Ax = torch.from_numpy(_interp_matrix(W, out_hw[1])).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(Ay, x), Ax.t())


def avg_pool2x2(img: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, floor output size. img: (..., H, W, C)."""
    H, W, C = img.shape[-3:]
    H2, W2 = H // 2, W // 2
    x = img[..., : H2 * 2, : W2 * 2, :].reshape(*img.shape[:-3], H2, 2, W2, 2, C)
    return x.mean(dim=(-4, -2))
