"""Multi-scale per-point correlation (counterpart of ``pips_tpu/ops/corr.py``).

* pyramid: L levels of 2x2-average-pooled feature maps;
* ``corr_pyramid``: per-point score maps ``dot(target, fmap) / sqrt(C)``;
* ``sample_corr_pyramid``: bilinear lookup of a (2r+1)^2 patch per level, in
  the reference's transposed order (patch[i, j] at (x + o_i, y + o_j)).
"""

from __future__ import annotations

import math

import torch

from pips_tpu_torch.ops.resize import avg_pool2x2
from pips_tpu_torch.ops.samp import grid_sample_zeros


def build_fmap_pyramid(fmaps: torch.Tensor, num_levels: int = 4) -> list[torch.Tensor]:
    """fmaps: (B, S, H, W, C) -> list of ``num_levels`` maps, each 2x downsampled."""
    pyramid = [fmaps]
    for _ in range(num_levels - 1):
        fmaps = avg_pool2x2(fmaps)
        pyramid.append(fmaps)
    return pyramid


def corr_pyramid(pyramid: list[torch.Tensor], targets: torch.Tensor,
                 out_dtype=torch.float32) -> list[torch.Tensor]:
    """targets: (B, S, N, C) -> list of (B, S, N, H_l, W_l) score maps.

    The product runs in the dtype promoted from targets, maps and
    ``out_dtype`` and accumulates in f32; the scale is applied to the f32 sum
    before the one rounding to ``out_dtype``, as the JAX version's f32 einsum
    and cast do. (bf16 products are exact in f32.)
    """
    B, S, N, C = targets.shape
    scale = 1.0 / math.sqrt(C)
    corrs = []
    for fm in pyramid:
        H, W = fm.shape[2], fm.shape[3]
        cd = torch.promote_types(torch.promote_types(targets.dtype, fm.dtype), out_dtype)
        a = targets.reshape(B * S, N, C).to(cd)
        b = fm.reshape(B * S, H * W, C).to(cd).transpose(1, 2)
        c = torch.baddbmm(torch.zeros((), dtype=cd, device=a.device), a, b,
                          beta=0.0, alpha=scale)
        corrs.append(c.to(out_dtype).reshape(B, S, N, H, W))
    return corrs


def sample_corr_pyramid(corrs: list[torch.Tensor], coords: torch.Tensor,
                        radius: int = 3) -> torch.Tensor:
    """Reference-semantics patch sampling from full score maps.

    corrs: list of (B, S, N, H_l, W_l); coords: (B, S, N, 2) at level-0 scale.
    Returns (B, S, N, L*(2r+1)^2), each patch flattened i-major.
    """
    B, S, N, _ = coords.shape
    P = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    out = []
    for lvl, corr in enumerate(corrs):
        H, W = corr.shape[3], corr.shape[4]
        c = coords / (2.0 ** lvl)
        x = (c[..., 0, None, None] + offs[:, None]).expand(B, S, N, P, P)
        y = (c[..., 1, None, None] + offs[None, :]).expand(B, S, N, P, P)
        img = corr.reshape(B * S * N, H, W, 1)
        patch = grid_sample_zeros(img, x.reshape(B * S * N, P * P), y.reshape(B * S * N, P * P))
        out.append(patch.reshape(B, S, N, P * P))
    return torch.cat(out, dim=-1)
