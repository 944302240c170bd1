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

from pips_tpu_torch.ops.corr import bilinear_from_integer_patch, integer_patch_index


def sample_corr_onehot(corrs: list[torch.Tensor], coords: torch.Tensor,
                       radius: int = 3) -> torch.Tensor:
    """Same values as ``ops.corr.sample_corr_pyramid``.

    corrs: list of (B, S, N, H_l, W_l); coords: (B, S, N, 2) at level-0 scale.
    Returns (B, S, N, L*(2r+1)^2) in f32.
    """
    out = []
    for lvl, corr in enumerate(corrs):
        H, W = corr.shape[-2:]
        idx, valid, wx, wy = integer_patch_index(coords / (2.0 ** lvl), H, W, radius)
        lead = corr.shape[:-2]
        g = torch.gather(corr.reshape(*lead, H * W), -1, idx)
        g = g.reshape(*valid.shape) * valid.to(corr.dtype)
        out.append(bilinear_from_integer_patch(g, wx, wy, radius))
    return torch.cat(out, dim=-1)
