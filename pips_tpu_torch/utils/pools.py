"""Running metric pools: a copy of ``pips_tpu/utils/pools.py`` (numpy only),
so the port needs nothing of the JAX package."""

from __future__ import annotations

import numpy as np


class SimplePool:
    """FIFO pool of scalars with windowed mean (n=100 train, n=10000 eval)."""

    def __init__(self, pool_size: int):
        assert pool_size > 0
        self.pool_size = pool_size
        self.items: list = []

    def __len__(self) -> int:
        return len(self.items)

    def update(self, items) -> None:
        for item in items:
            if len(self.items) >= self.pool_size:
                self.items.pop(0)
            self.items.append(float(item))

    def mean(self) -> float:
        if not self.items:
            return float("nan")
        return float(np.mean(self.items))

    def is_full(self) -> bool:
        return len(self.items) == self.pool_size

    def empty(self) -> None:
        self.items = []

    def fetch(self) -> np.ndarray:
        return np.asarray(self.items)

    def sample(self, rng=None) -> float:
        rng = rng or np.random
        return self.items[rng.randint(len(self.items))]


class MovingAverage:
    """Exponential moving average scalar."""

    def __init__(self, beta: float = 0.99):
        self.beta = beta
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = float(x) if self.value is None else \
            self.beta * self.value + (1 - self.beta) * float(x)
        return self.value
