"""Masked reductions and min-max normalisation (counterpart of
``pips_tpu/ops/reduce.py``)."""

from __future__ import annotations

import torch

EPS = 1e-6


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                       keepdim: bool = False) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` is nonzero: sum(x*mask) / (EPS + sum(mask))."""
    prod = x * mask
    if dim is None:
        return prod.sum() / (EPS + mask.sum())
    return prod.sum(dim=dim, keepdim=keepdim) / (EPS + mask.sum(dim=dim, keepdim=keepdim))


def normalize_single(d: torch.Tensor) -> torch.Tensor:
    dmin, dmax = d.min(), d.max()
    return (d - dmin) / (EPS + (dmax - dmin))


def normalize(d: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each batch element independently."""
    flat = d.reshape(d.shape[0], -1)
    shape = (d.shape[0],) + (1,) * (d.dim() - 1)
    dmin, dmax = flat.min(dim=1).values.reshape(shape), flat.max(dim=1).values.reshape(shape)
    return (d - dmin) / (EPS + (dmax - dmin))
