"""Farthest point sampling (counterpart of ``pips_tpu/ops/fps.py``; capability
parity: reference ``utils/misc.py:147-199``)."""

from __future__ import annotations

import numpy as np
import torch


def farthest_point_sample_py(xyz: np.ndarray, npoint: int,
                             rng: np.random.RandomState | None = None) -> np.ndarray:
    """xyz: (N, C) -> (npoint,) indices, numpy host-side variant."""
    rng = rng or np.random
    N, C = xyz.shape
    inds = np.zeros(npoint, np.int32)
    distance = np.full(N, 1e10)
    farthest = int(rng.randint(0, N))
    for i in range(npoint):
        inds[i] = farthest
        dist = ((xyz - xyz[farthest]) ** 2).sum(-1)
        mask = dist < distance
        distance[mask] = dist[mask]
        farthest = int(np.argmax(distance))
        if npoint > N:
            distance += rng.randn(*distance.shape)
    return inds


def farthest_point_sample(xyz: torch.Tensor, npoint: int, deterministic: bool = False,
                          include_ends: bool = False, seed: int = 0) -> torch.Tensor:
    """Batched variant on the tensor's device. xyz: (B, N, C) -> (B, npoint)
    int32 indices.

    A python loop of ``npoint`` masked argmax updates (npoint is small in
    practice; each step is a vectorized reduction). The random starts come
    from ``np.random.RandomState(seed)``, as in the JAX package, so both pick
    the same indices. ``include_ends`` pins samples 0/1 to the first/last
    input points (reference ``utils/misc.py:166-170``).
    """
    B, N, C = xyz.shape
    dev = xyz.device
    if deterministic:
        farthest = torch.zeros(B, dtype=torch.long, device=dev)
    else:
        rng = np.random.RandomState(seed)
        farthest = torch.as_tensor(rng.randint(0, N, size=(B,)), dtype=torch.long, device=dev)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=dev)
    out = []
    batch = torch.arange(B, device=dev)
    for i in range(npoint):
        if include_ends and i == 0:
            farthest = torch.zeros(B, dtype=torch.long, device=dev)
        elif include_ends and i == 1:
            farthest = torch.full((B,), N - 1, dtype=torch.long, device=dev)
        out.append(farthest)
        centroid = xyz[batch, farthest][:, None, :]  # (B, 1, C)
        dist = torch.sum((xyz - centroid) ** 2, -1)
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, -1)
    return torch.stack(out, dim=1).to(torch.int32)
