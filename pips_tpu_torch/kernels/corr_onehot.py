"""Patch sampling of the correlation pyramid, serving form.

Counterpart of ``pips_tpu/kernels/corr_pallas.py:sample_corr_onehot``. The
JAX version is plain XLA, not a Pallas kernel: it selects the (2r+2)^2
integer score patch with one-hot matmuls because a gather is slow on a TPU.
Here the same patch is read with a gather: a one-hot selection picks single
elements exactly, so the values are the same. Out-of-bounds taps are zero.

Patches come in the reference's transposed order: patch[i, j] is sampled at
(x + o_i, y + o_j), flattened i-major.
"""

from __future__ import annotations

import torch


def _integer_patch(corr: torch.Tensor, coords: torch.Tensor, radius: int):
    """corr: (..., H, W) score maps; coords: (..., 2) xy at this level's scale.

    Returns (g, wx, wy): g (..., G, G) with g[a, b] the score at
    (y0 - r + a, x0 - r + b) (zero outside the map), and the fractional
    weights wx, wy (...,) in f32.
    """
    H, W = corr.shape[-2:]
    G = 2 * radius + 2
    x, y = coords[..., 0].float(), coords[..., 1].float()
    x0f, y0f = torch.floor(x), torch.floor(y)
    a = torch.arange(G, device=corr.device)
    rows = y0f.long()[..., None] - radius + a  # (..., G)
    cols = x0f.long()[..., None] - radius + a
    valid = (((rows >= 0) & (rows < H))[..., :, None]
             & ((cols >= 0) & (cols < W))[..., None, :])  # (..., G, G)
    idx = rows.clamp(0, H - 1)[..., :, None] * W + cols.clamp(0, W - 1)[..., None, :]
    lead = corr.shape[:-2]
    g = torch.gather(corr.reshape(*lead, H * W), -1, idx.reshape(*lead, G * G))
    g = g.reshape(*lead, G, G) * valid.to(corr.dtype)
    return g, x - x0f, y - y0f


def _bilinear_from_integer_patch(g: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                                 radius: int) -> torch.Tensor:
    """g: (..., G, G) integer scores [row a, col b]; returns (..., P*P) in the
    reference's transposed order."""
    P = 2 * radius + 1
    G = P + 1
    wxe = wx[..., None, None]
    wye = wy[..., None, None]
    interp = ((1 - wye) * (1 - wxe) * g[..., 0:P, 0:P]
              + (1 - wye) * wxe * g[..., 0:P, 1:G]
              + wye * (1 - wxe) * g[..., 1:G, 0:P]
              + wye * wxe * g[..., 1:G, 1:G])  # indexed [j, i]
    return interp.transpose(-1, -2).reshape(*g.shape[:-2], P * P)


def sample_corr_onehot(corrs: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 3) -> torch.Tensor:
    """Same values as ``ops.corr.sample_corr_pyramid``.

    corrs: list of (B, S, N, H_l, W_l); coords: (B, S, N, 2) at level-0 scale.
    Returns (B, S, N, L*(2r+1)^2) in f32.
    """
    out = []
    for lvl, corr in enumerate(corrs):
        g, wx, wy = _integer_patch(corr, coords / (2.0 ** lvl), radius)
        out.append(_bilinear_from_integer_patch(g, wx, wy, radius))
    return torch.cat(out, dim=-1)
