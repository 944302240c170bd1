"""Bilinear point sampling (counterpart of ``pips_tpu/ops/samp.py``).

Two semantics, both kept from the reference:

* ``grid_sample_zeros``: zero padding, as ``F.grid_sample(align_corners=True)``;
  out-of-bounds corner taps contribute zero (corr-patch lookup).
* ``bilinear_sample2d``: corner indices clamped to the border, weights from
  the unclamped coords, so out-of-bounds queries replicate the border
  (ffeat initialisation).

Images are channel-last (B, H, W, C); coordinates are xy pixel coords.
"""

from __future__ import annotations

import torch


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img: (B, H, W, C); iy/ix: (B, ...) in-range int64. Returns (B, ..., C)."""
    B, H, W, C = img.shape
    idx = (iy * W + ix).reshape(B, -1, 1).expand(-1, -1, C)
    out = torch.gather(img.reshape(B, H * W, C), 1, idx)
    return out.reshape(*iy.shape, C)


def _corners(x: torch.Tensor, y: torch.Tensor):
    x, y = x.float(), y.float()
    x0f, y0f = torch.floor(x), torch.floor(y)
    return x, y, x0f, y0f, x0f.long(), y0f.long()


def grid_sample_zeros(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding at align-corners pixel coords.

    img: (B, H, W, C); x, y: (B, ...). Returns (B, ..., C).
    """
    B, H, W, C = img.shape
    x, y, x0f, y0f, x0, y0 = _corners(x, y)
    wx, wy = x - x0f, y - y0f

    def tap(iy, ix):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        v = _gather_hw(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
        return v * valid[..., None].to(img.dtype)

    w00 = ((1.0 - wx) * (1.0 - wy))[..., None]
    w01 = (wx * (1.0 - wy))[..., None]
    w10 = ((1.0 - wx) * wy)[..., None]
    w11 = (wx * wy)[..., None]
    return (tap(y0, x0) * w00 + tap(y0, x0 + 1) * w01
            + tap(y0 + 1, x0) * w10 + tap(y0 + 1, x0 + 1) * w11)


def bilinear_sample2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Border-replicating bilinear point sample. img: (B, H, W, C); x, y: (B, N).
    Returns (B, N, C)."""
    B, H, W, C = img.shape
    x, y, x0f, y0f, x0, y0 = _corners(x, y)
    x0c, x1c = x0.clamp(0, W - 1), (x0 + 1).clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), (y0 + 1).clamp(0, H - 1)
    x1f, y1f = x0f + 1.0, y0f + 1.0
    w00 = ((x1f - x) * (y1f - y))[..., None]
    w01 = ((x - x0f) * (y1f - y))[..., None]
    w10 = ((x1f - x) * (y - y0f))[..., None]
    w11 = ((x - x0f) * (y - y0f))[..., None]
    return (w00 * _gather_hw(img, y0c, x0c) + w01 * _gather_hw(img, y0c, x1c)
            + w10 * _gather_hw(img, y1c, x0c) + w11 * _gather_hw(img, y1c, x1c))
