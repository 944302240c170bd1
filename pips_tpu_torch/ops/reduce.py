"""Masked reductions and min-max normalisation (counterpart of
``pips_tpu/ops/reduce.py``)."""

from __future__ import annotations

import torch

EPS = 1e-6


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                       keepdims: bool = False) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` is nonzero: sum(x*mask) / (EPS + sum(mask)),
    over ``axis`` (an int, a tuple, or None for all) as JAX's takes it."""
    prod = x * mask
    if axis is None:
        if keepdims:
            axis = tuple(range(x.dim()))
        else:
            return prod.sum() / (EPS + mask.sum())
    return prod.sum(dim=axis, keepdim=keepdims) / (EPS + mask.sum(dim=axis, keepdim=keepdims))


def normalize_single(d: torch.Tensor) -> torch.Tensor:
    dmin, dmax = d.min(), d.max()
    return (d - dmin) / (EPS + (dmax - dmin))


def normalize(d: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each batch element independently."""
    flat = d.reshape(d.shape[0], -1)
    shape = (d.shape[0],) + (1,) * (d.dim() - 1)
    dmin, dmax = flat.min(dim=1).values.reshape(shape), flat.max(dim=1).values.reshape(shape)
    return (d - dmin) / (EPS + (dmax - dmin))
