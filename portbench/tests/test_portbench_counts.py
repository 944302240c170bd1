"""The operation counts behind ``mfu.*`` and the channel block's bounds."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.reference import pips as ref
from portbench.reference.params import make_params

TINY = dict(S=8, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("stride, H, W, N", [(8, 64, 96, 7), (4, 64, 96, 5)])
def test_forward_count_matches_the_flop_counter_on_the_reference(stride, H, W, N):
    cfg = dict(TINY, stride=stride)
    p = make_params(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(0)
    rgbs = torch.rand(1, 8, H, W, 3, generator=gen) * 255
    xys = torch.rand(1, N, 2, generator=gen) * torch.tensor([W - 1.0, H - 1.0])
    got = counted(lambda: ref.window(p, cfg, rgbs, xys, 3, ref.Precision()))
    assert roofline.forward_flops(cfg, 1, 8, H, W, N, 3) == got


def test_train_forward_count_matches_the_flop_counter_on_the_reference():
    cfg = dict(TINY)
    p = make_params(cfg, 4, "cpu")
    gen = torch.Generator().manual_seed(1)
    H, W, N = 64, 96, 6
    batch = {"rgbs": torch.rand(1, 8, H, W, 3, generator=gen) * 255,
             "trajs": torch.rand(1, 8, N, 2, generator=gen) * torch.tensor([W - 1.0, H - 1.0]),
             "visibles": torch.ones(1, 8, N), "valids": torch.ones(1, 8, N)}
    got = counted(lambda: ref.train_loss(p, cfg, batch, 2, ref.Precision()))
    assert roofline.forward_flops(cfg, 4, 8, H, W, N, 2, train=True) == got


# PERF.md §6, the bound column of the channel block's forward and backward
@pytest.mark.parametrize("R, dtype, D, F, ms, by", [
    (2048, "bfloat16", 512, 2048, 0.0087, "operations"),
    (24576, "bfloat16", 512, 2048, 0.1042, "operations"),
    (61440, "bfloat16", 512, 2048, 0.2606, "operations"),
    (2048, "float32", 512, 2048, 0.1282, "operations"),
    (24576, "float32", 512, 2048, 1.5385, "operations"),
    (2048, "bfloat16", 256, 1024, 0.0022, "operations"),
    (6144, "bfloat16", 256, 1024, 0.0065, "operations"),
    (73728, "bfloat16", 256, 1024, 0.0782, "operations"),
    (100, "bfloat16", 256, 1024, 0.0003, "bytes"),
])
def test_forward_bound_gives_the_kernel_tables_bound(R, dtype, D, F, ms, by):
    got, which = roofline.chanff_bound(R, dtype, D, F)
    assert round(got, 4) == ms and which == by


@pytest.mark.parametrize("R, dtype, D, F, ms", [
    (24576, "bfloat16", 512, 2048, 0.2606),
    (1024, "bfloat16", 512, 2048, 0.0109),
    (2048, "bfloat16", 256, 1024, 0.0054),
    (73728, "bfloat16", 256, 1024, 0.1954),
    (100, "bfloat16", 256, 1024, 0.0010),
    (24576, "float32", 512, 2048, 3.8462),
    (1024, "float32", 512, 2048, 0.1603),
])
def test_backward_bound_gives_the_kernel_tables_bound(R, dtype, D, F, ms):
    assert round(roofline.chanff_bwd_bound(R, dtype, D, F)[0], 4) == ms
