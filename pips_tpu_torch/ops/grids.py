"""Coordinate-grid constructors (counterpart of ``pips_tpu/ops/grids.py``), xy order."""

from __future__ import annotations

import torch


def meshgrid2d(B: int, Y: int, X: int, stack: bool = False, dtype=torch.float32, device=None):
    """Return (grid_y, grid_x), each (B, Y, X); or stacked (B, Y, X, 2) in xy order."""
    grid_y = torch.arange(Y, dtype=dtype, device=device)[None, :, None].expand(B, Y, X)
    grid_x = torch.arange(X, dtype=dtype, device=device)[None, None, :].expand(B, Y, X)
    if stack:
        return torch.stack([grid_x, grid_y], dim=-1)
    return grid_y, grid_x


def gridcloud2d(B: int, Y: int, X: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """All pixel centers as a point list: (B, Y*X, 2) in xy order, row-major over (y, x)."""
    grid_y, grid_x = meshgrid2d(B, Y, X, dtype=dtype, device=device)
    return torch.stack([grid_x.reshape(B, -1), grid_y.reshape(B, -1)], dim=2)


def coords_grid(batch: int, ht: int, wd: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense coordinate image (batch, ht, wd, 2) in xy order (channel-last)."""
    return meshgrid2d(batch, ht, wd, stack=True, dtype=dtype, device=device)
