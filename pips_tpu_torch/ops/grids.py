"""Coordinate-grid constructors (counterpart of ``pips_tpu/ops/grids.py``), xy order."""

from __future__ import annotations

import torch


def meshgrid2d(B: int, Y: int, X: int, dtype=torch.float32, device=None):
    """Return (grid_y, grid_x), each (B, Y, X)."""
    grid_y = torch.arange(Y, dtype=dtype, device=device)[None, :, None].expand(B, Y, X)
    grid_x = torch.arange(X, dtype=dtype, device=device)[None, None, :].expand(B, Y, X)
    return grid_y, grid_x


def gridcloud2d(B: int, Y: int, X: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """All pixel centers as a point list: (B, Y*X, 2) in xy order, row-major over (y, x)."""
    grid_y, grid_x = meshgrid2d(B, Y, X, dtype=dtype, device=device)
    return torch.stack([grid_x.reshape(B, -1), grid_y.reshape(B, -1)], dim=2)
