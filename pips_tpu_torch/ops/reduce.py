"""Masked reductions and min-max normalisation (counterpart of
``pips_tpu/ops/reduce.py``)."""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Iterator, Optional

import torch

EPS = 1e-6

_SUM_OVER_PROCESSES: ContextVar[Optional[Callable[[torch.Tensor], torch.Tensor]]] = ContextVar(
    "sum_over_processes", default=None)


@contextlib.contextmanager
def denominators_summed(fn: Callable[[torch.Tensor], torch.Tensor]) -> Iterator[None]:
    """Inside the block every masked mean's denominator is ``fn(local sum)``:
    ``parallel.global_masked_means`` sums it over the processes that share a
    batch, so that each process's sum of masked values over the global
    denominator adds up, over the processes, to the mean of the whole batch."""
    token = _SUM_OVER_PROCESSES.set(fn)
    try:
        yield
    finally:
        _SUM_OVER_PROCESSES.reset(token)


def mask_count(mask_sum: torch.Tensor) -> torch.Tensor:
    """A masked mean's denominator: the local sum, or its sum over the
    processes inside ``denominators_summed``."""
    fn = _SUM_OVER_PROCESSES.get()
    return mask_sum if fn is None else fn(mask_sum)


def reduce_masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                       keepdims: bool = False) -> torch.Tensor:
    """Mean of ``x`` where ``mask`` is nonzero: sum(x*mask) / (EPS + sum(mask)),
    over ``axis`` (an int, a tuple, or None for all) as JAX's takes it."""
    prod = x * mask
    if axis is None:
        if keepdims:
            axis = tuple(range(x.dim()))
        else:
            return prod.sum() / (EPS + mask_count(mask.sum()))
    return prod.sum(dim=axis, keepdim=keepdims) / (
        EPS + mask_count(mask.sum(dim=axis, keepdim=keepdims)))


def normalize_single(d: torch.Tensor) -> torch.Tensor:
    dmin, dmax = d.min(), d.max()
    return (d - dmin) / (EPS + (dmax - dmin))


def normalize(d: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each batch element independently."""
    flat = d.reshape(d.shape[0], -1)
    shape = (d.shape[0],) + (1,) * (d.dim() - 1)
    dmin, dmax = flat.min(dim=1).values.reshape(shape), flat.max(dim=1).values.reshape(shape)
    return (d - dmin) / (EPS + (dmax - dmin))
