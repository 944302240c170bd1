"""Multi-scale per-point correlation (counterpart of ``pips_tpu/ops/corr.py``).

* pyramid: L levels of 2x2-average-pooled feature maps;
* ``corr_pyramid``: per-point score maps ``dot(target, fmap) / sqrt(C)``;
* ``sample_corr_pyramid``: bilinear lookup of a (2r+1)^2 patch per level, in
  the reference's transposed order (patch[i, j] at (x + o_i, y + o_j));
* ``fused_corr_sample``: the same patches without the score maps. The patch
  offsets are integers, so all taps share one fractional offset and the
  bilinear patch is a combination of a (2r+2)^2 integer score patch; corr is
  linear in the map, so that patch is ``dot(target, gathered map patch)``.
  This is the plain version of the CUDA kernel ``kernels.corr_cuda``.
* ``fused_pyramid_fmap`` / ``fcp_from_fused``: the train-time score maps
  ``sum_l resize(corr_l)`` as one product against the sum of the resized
  levels (corr is linear in the map, the resize linear over (h, w));
  ``fcp_score_maps`` is the per-level form they equal.
"""

from __future__ import annotations

import math

import torch

from pips_tpu_torch.ops.resize import avg_pool2x2, resize_bilinear_align_corners
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


def integer_patch_index(coords: torch.Tensor, H: int, W: int, radius: int):
    """The (2r+2)^2 integer patch around floor(coords) on an H x W map.

    coords: (..., 2) xy at this level's scale. Returns (idx, valid, wx, wy):
    idx (..., G*G) flat pixel indices clamped into the map, with
    idx[a*G + b] at (y0 - r + a, x0 - r + b); valid (..., G, G) marks the
    taps inside the map; wx, wy (...,) are the f32 fractional offsets.
    """
    G = 2 * radius + 2
    x, y = coords[..., 0].float(), coords[..., 1].float()
    x0f, y0f = torch.floor(x), torch.floor(y)
    a = torch.arange(G, device=coords.device)
    rows = y0f.long()[..., None] - radius + a  # (..., G)
    cols = x0f.long()[..., None] - radius + a
    valid = (((rows >= 0) & (rows < H))[..., :, None]
             & ((cols >= 0) & (cols < W))[..., None, :])
    idx = rows.clamp(0, H - 1)[..., :, None] * W + cols.clamp(0, W - 1)[..., None, :]
    return idx.reshape(*idx.shape[:-2], G * G), valid, x - x0f, y - y0f


def bilinear_from_integer_patch(g: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                                radius: int) -> torch.Tensor:
    """g: (..., G, G) integer scores [row a, col b]; returns (..., P*P) in the
    reference's transposed order: out[i*P + j] samples (x + o_i, y + o_j)."""
    P = 2 * radius + 1
    G = P + 1
    wxe = wx[..., None, None]
    wye = wy[..., None, None]
    interp = ((1 - wye) * (1 - wxe) * g[..., 0:P, 0:P]
              + (1 - wye) * wxe * g[..., 0:P, 1:G]
              + wye * (1 - wxe) * g[..., 1:G, 0:P]
              + wye * wxe * g[..., 1:G, 1:G])  # indexed [j, i]
    return interp.transpose(-1, -2).reshape(*g.shape[:-2], P * P)


def fused_corr_sample(pyramid: list[torch.Tensor], targets: torch.Tensor,
                      coords: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Same values as ``corr_pyramid`` -> ``sample_corr_pyramid``, without
    the (B, S, N, H_l, W_l) score maps.

    pyramid: list of (B, S, H_l, W_l, C); targets: (B, S, N, C); coords:
    (B, S, N, 2) at level-0 scale. Returns (B, S, N, L*(2r+1)^2) in f32.
    Each score is an f32 sum of f32 products (exact for bf16 operands; an
    elementwise product, so no TF32), scaled by 1/sqrt(C) after the sum.
    Out-of-bounds taps are zero.
    """
    B, S, N, C = targets.shape
    G = 2 * radius + 2
    scale = 1.0 / math.sqrt(C)
    tf = targets.float()[..., None, None, :]  # (B, S, N, 1, 1, C)
    out = []
    for lvl, fm in enumerate(pyramid):
        H, W = fm.shape[2], fm.shape[3]
        idx, valid, wx, wy = integer_patch_index(coords / (2.0 ** lvl), H, W, radius)
        patch = torch.gather(fm.reshape(B, S, H * W, C), 2,
                             idx.reshape(B, S, N * G * G, 1).expand(-1, -1, -1, C))
        g = (patch.reshape(B, S, N, G, G, C).float() * tf).sum(-1) * scale
        g = torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))
        out.append(bilinear_from_integer_patch(g, wx, wy, radius))
    return torch.cat(out, dim=-1)


def _resize_channel_last(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., H_out, W_out, C); the resize works on the last two axes."""
    return resize_bilinear_align_corners(x.movedim(-1, -3), out_hw).movedim(-3, -1)


def fused_pyramid_fmap(pyramid: list[torch.Tensor], out_hw: tuple[int, int]) -> torch.Tensor:
    """Sum of the pyramid levels (B, S, H_l, W_l, C), each align-corners
    upsampled to ``out_hw``: (B, S, H8, W8, C), in the levels' dtype."""
    acc = None
    for fm in pyramid:
        up = _resize_channel_last(fm, out_hw)
        acc = up if acc is None else acc + up
    return acc


def fcp_from_fused(fm_fcp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Train-time score maps (B, S, N, H8, W8), f32, from the fused map; equal
    up to rounding to ``fcp_score_maps(corr_pyramid(pyramid, targets), out_hw)``."""
    return corr_pyramid([fm_fcp], targets)[0]


def fcp_score_maps(corrs: list[torch.Tensor], out_hw: tuple[int, int]) -> torch.Tensor:
    """Sum of the score maps (B, S, N, H_l, W_l), each align-corners upsampled
    to ``out_hw``: (B, S, N, H8, W8) in f32."""
    B, S, N = corrs[0].shape[:3]
    fcp = torch.zeros((B, S, N, *out_hw), dtype=torch.float32, device=corrs[0].device)
    for c in corrs:
        fcp = fcp + resize_bilinear_align_corners(c, out_hw)
    return fcp
