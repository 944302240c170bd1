"""Peaks of the card, and operations and bytes counted from shapes.

The peaks are NVIDIA's published dense rates for one H100 SXM at its full
700 W limit. ``chanff_bound`` and ``chanff_bwd_bound`` are copied from
``chip_smoke.py`` (commit 58c35d9), which keeps them as its kernel gate:
the least time of the channel block's forward and backward, count each
operand byte once and each operation once. ``forward_flops`` counts the
products of one PIPs forward (convs, score maps, the mixer's dense products
and the heads) from shapes alone, whatever implements them; elementwise
work, pooling, resizes and gathers are not counted.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
STAGES = (64, 96, 128, 128)


def chanff_bound(R: int, dtype: str, D: int = 512, F: int = 2048):
    """Least time for the block: 4RDF operations at the dtype's peak, or x and
    y once, both weights once and the f32 vectors once at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * R * D * F
    nbytes = 2 * R * D * esize + 2 * D * F * esize + 4 * (3 * D + F)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chanff_bwd_bound(R: int, dtype: str = "bfloat16", D: int = 512, F: int = 2048):
    """Least time for the backward: five products of 2RDF operations (a1
    recomputed, dg1, dxa, dw1, dw2) at the dtype's peak, or x, dy and dx once,
    both weights in the dtype and the f32 vectors once, the f32 weight and
    vector grads once, at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 10.0 * R * D * F
    nbytes = (3 * R * D * esize + 2 * D * F * esize + 4 * (2 * D + F) + 2 * D * F * 4
              + 4 * (3 * D + F))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _conv(o: int, i: int, k: int, s: int, p: int, h: int, w: int):
    """Operations of one image's conv and its output size."""
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return 2.0 * o * i * k * k * ho * wo, ho, wo


def encoder_flops(cfg: dict, H: int, W: int) -> float:
    """One frame through the encoder."""
    total, h, w = _conv(STAGES[0], 3, 7, 2, 3, H, W)
    c = STAGES[0]
    for i, dim in enumerate(STAGES):
        for j in range(2):
            s = 2 if (i > 0 and j == 0) else 1
            f1, ho, wo = _conv(dim, c, 3, s, 1, h, w)
            f2, _, _ = _conv(dim, dim, 3, 1, 1, ho, wo)
            total += f1 + f2
            if s != 1:
                total += _conv(dim, c, 1, s, 0, h, w)[0]
            c, h, w = dim, ho, wo
    h8, w8 = H // cfg["stride"], W // cfg["stride"]
    C = cfg["latent_dim"]
    total += _conv(2 * C, sum(STAGES), 3, 1, 1, h8, w8)[0]
    total += _conv(C, 2 * C, 1, 1, 0, h8, w8)[0]
    return total


def iteration_flops(cfg: dict, B: int, S: int, H: int, W: int, N: int,
                    train: bool = False) -> float:
    """One refinement iteration: the score maps of every level (and with
    ``train`` the score maps against the fused level-0 map), the mixer and
    the feature updater."""
    C, D, depth = cfg["latent_dim"], cfg["mixer_dim"], cfg["mixer_depth"]
    h, w = H // cfg["stride"], W // cfg["stride"]
    pixels = 0
    for _ in range(cfg["corr_levels"]):
        pixels += h * w
        h, w = h // 2, w // 2
    if train:
        pixels += (H // cfg["stride"]) * (W // cfg["stride"])
    corr = 2.0 * B * S * N * C * pixels
    M = B * N
    kitchen = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2 + C + 64 * 3 + 3
    mixer = 2.0 * M * S * kitchen * D
    mixer += depth * (2 * (2.0 * M * D * S * 4 * S) + 2 * (2.0 * M * S * D * 4 * D))
    mixer += 2.0 * M * D * S * (C + 2)
    return corr + mixer + 2.0 * M * S * C * C


def forward_flops(cfg: dict, B: int, S: int, H: int, W: int, N: int, iters: int,
                  train: bool = False) -> float:
    """One forward of B windows of S frames at H x W with N points."""
    return (B * S * encoder_flops(cfg, H, W)
            + iters * iteration_flops(cfg, B, S, H, W, N, train)
            + 2.0 * B * S * N * cfg["latent_dim"])
