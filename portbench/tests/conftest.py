"""Shared fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``chip`` marker and skip inside the
test when there is none; every other test runs the harness on the CPU at
TINY widths, with the port's plain versions in place of its kernels.
"""

from __future__ import annotations

import copy

import pytest

TINY_MODEL = dict(latent_dim=16, mixer_dim=32, mixer_depth=2, corr_levels=3, corr_radius=2)
TINY_TRAFFIC = dict(H=96, W=128, pool_clips=4, sprites=3, sprite_size=20, max_vel=4.0,
                    warmup_windows=1, checked_windows=2, profiled_windows=1, query_stride=16,
                    grid=4, N=24, checked_steps=3, profiled_steps=1,
                    profiled_calls=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell as ``BENCHMARK.json`` and its files give it,
    at TINY widths and frame sizes; its limits are the cell's own."""
    from portbench import spec

    def make(name: str) -> dict:
        cell = copy.deepcopy(spec.cell(name, spec.benchmark()))
        cell["model"].update(TINY_MODEL)
        params = cell["work"]["params"]
        params.update({k: v for k, v in TINY_TRAFFIC.items()
                       if k in params or k.startswith("profiled_")})
        return cell

    return make


@pytest.fixture
def ctx_of():
    from portbench import common

    def make(cell: dict, seed: int = 2**33 + 17, seconds: float = 1.0):
        return common.Context(cell, seed, seconds, False, "cpu")

    return make
