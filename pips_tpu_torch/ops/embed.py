"""Sinusoidal embedding of the DeltaBlock's flow input
(counterpart of ``pips_tpu/ops/embed.py:get_3d_embedding``).

Frequencies ``arange(0, C, 2) * (1000 / C)`` with sin/cos interleaved on the
channel axis, as the reference's ``utils/misc.py`` has it.
"""

from __future__ import annotations

import torch


def get_3d_embedding(xyz: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    """xyz: (B, N, 3) -> (B, N, 3*C [+3]): [pe_x, pe_y, pe_z (, xyz)]."""
    B, N, D = xyz.shape
    if D != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    div_term = torch.arange(0, C, 2, dtype=torch.float32, device=xyz.device) * (1000.0 / C)
    angles = xyz[..., None] * div_term  # (B, N, 3, C/2)
    pe = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(B, N, 3 * C)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=2)
    return pe
