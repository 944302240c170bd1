"""Align-corners bilinear resize and 2x2 average pooling
(counterpart of ``pips_tpu/ops/resize.py``), and the half-pixel linear and
cubic resizes of ``jax.image.resize`` that the DINO baseline uses.

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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (``jax.image``'s "cubic")."""
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


@functools.lru_cache(maxsize=128)
def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) f32 weights of ``jax.image.resize(..., method)`` along
    one axis ("linear" or "cubic"): half-pixel centers; where it shrinks
    the kernel widens by the scale (antialiasing); taps off the input are
    dropped and each output's weights renormalised to sum to 1. Computed in
    f32 as JAX computes it (``jax/_src/image/scale.py:compute_weight_mat``)."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T.astype(np.float32))


def resize_half_pixel(x: torch.Tensor, out_hw: tuple[int, int], method: str = "linear"
                      ) -> torch.Tensor:
    """x: (..., H, W) -> (..., H_out, W_out), ``jax.image.resize``'s
    half-pixel "linear" or "cubic" resize of the last two axes, as two
    matmuls with ``resize_matrix``'s weights in x's dtype."""
    H, W = x.shape[-2:]
    Ay = torch.from_numpy(resize_matrix(H, out_hw[0], method)).to(x.device, x.dtype)
    Ax = torch.from_numpy(resize_matrix(W, out_hw[1], method)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(Ay, x), Ax.t())


def avg_pool2x2(img: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, floor output size. img: (..., H, W, C)."""
    H, W, C = img.shape[-3:]
    H2, W2 = H // 2, W // 2
    x = img[..., : H2 * 2, : W2 * 2, :].reshape(*img.shape[:-3], H2, 2, W2, 2, C)
    return x.mean(dim=(-4, -2))
