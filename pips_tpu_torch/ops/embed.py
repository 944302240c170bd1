"""Sinusoidal positional embeddings (counterpart of ``pips_tpu/ops/embed.py``).

``get_3d_embedding`` embeds the DeltaBlock's flow input with the reference's
own scheme (``utils/misc.py:44-69``): frequencies ``arange(0, C, 2) *
(1000 / C)`` with sin/cos interleaved on the channel axis.
``posemb_sincos_2d_xy`` and ``posemb_sincos_3d`` are the standard
``1 / temperature ** (i / (n - 1))`` embeddings in blocks of sin and cos
(``utils/misc.py:4-42``). All compute in f32.
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


def _omega(n: int, temperature: float, device) -> torch.Tensor:
    omega = torch.arange(n, dtype=torch.float32, device=device) / (n - 1)
    return 1.0 / (temperature ** omega)


def posemb_sincos_2d_xy(x: torch.Tensor, y: torch.Tensor, temperature: float = 10000.0,
                        dim: int = 64) -> torch.Tensor:
    """x, y: (B, S) -> (B, S, dim), blocks [sin(x), cos(x), sin(y), cos(y)]."""
    B, S = x.shape
    if dim % 4:
        raise ValueError(f"dim must be a multiple of 4, got {dim}")
    omega = _omega(dim // 4, temperature, x.device)
    xw = x.reshape(-1, 1).float() * omega
    yw = y.reshape(-1, 1).float() * omega
    pe = torch.cat([torch.sin(xw), torch.cos(xw), torch.sin(yw), torch.cos(yw)], dim=1)
    return pe.reshape(B, S, dim)


def posemb_sincos_3d(xyz: torch.Tensor, temperature: float = 10000.0, dim: int = 64,
                     cat_coords: bool = False) -> torch.Tensor:
    """xyz: (B, N, 3) -> (B, N, 3*dim [+3]), per axis the blocks [sin, cos]."""
    B, N, D = xyz.shape
    if D != 3 or dim % 2:
        raise ValueError(f"xyz must be (B, N, 3) and dim even, got {tuple(xyz.shape)}, {dim}")
    omega = _omega(dim // 2, temperature, xyz.device)
    parts = []
    for i in range(3):
        w = xyz[:, :, i].reshape(-1, 1).float() * omega
        parts.extend([torch.sin(w), torch.cos(w)])
    pe = torch.cat(parts, dim=1).reshape(B, N, dim * 3)
    if cat_coords:
        pe = torch.cat([pe, xyz], dim=2)
    return pe
