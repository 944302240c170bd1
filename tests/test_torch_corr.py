"""The port's fused corr sampler (ops.corr.fused_corr_sample and the CPU path
of kernels.corr_cuda.corr_sample) against the JAX package.

Same numpy inputs through both, on the setup of tests/test_kernels.py
(coords up to 4 px outside the map on every side, so patches cross the
border). The pyramid is built once, by JAX, and handed to both, so bf16 cases
compare the samplers and not two poolings.

Tolerances: both sides form each score as an f32 sum of f32 products (exact
for bf16 operands) and differ only in summation order, so every dtype pair is
held to 1e-5 against outputs up to ~2.5 (measured: at most 3.6e-7). The
Pallas kernel in interpret mode takes its scores from a dot over the whole
padded map, the same products in yet another order: also 1e-5 (measured:
at most 3.6e-7).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.kernels import corr_pallas
from pips_tpu.ops import corr as jcorr
from pips_tpu_torch.kernels import corr_cuda
from pips_tpu_torch.ops import corr

TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (map dtype, target dtype): serving, first iteration of a bf16 window, f32
PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("float32", "float32")]


@pytest.fixture
def setup(rng):
    B, S, N, C, H, W = 1, 2, 8, 16, 24, 32
    fmaps = rng.randn(B, S, H, W, C).astype(np.float32)
    targets = rng.randn(B, S, N, C).astype(np.float32)
    coords = np.stack([rng.uniform(-4, W + 3, (B, S, N)),
                       rng.uniform(-4, H + 3, (B, S, N))], axis=-1).astype(np.float32)
    return fmaps, targets, coords


def _both(fmaps, targets, coords, map_dt, tgt_dt, levels=3):
    """The JAX pyramid and targets, and the same values as torch tensors."""
    jpyr = jcorr.build_fmap_pyramid(jnp.asarray(fmaps, JDT[map_dt]), levels)
    jt = jnp.asarray(targets, JDT[tgt_dt])
    tpyr = [torch.from_numpy(np.array(p, np.float32)).to(TDT[map_dt]) for p in jpyr]
    tt = torch.from_numpy(np.array(jt, np.float32)).to(TDT[tgt_dt])
    return jpyr, jt, tpyr, tt


@pytest.mark.parametrize("map_dt,tgt_dt", PAIRS)
def test_fused_corr_sample_matches_jax(setup, map_dt, tgt_dt):
    fmaps, targets, coords = setup
    jpyr, jt, tpyr, tt = _both(fmaps, targets, coords, map_dt, tgt_dt)
    want = np.asarray(jcorr.fused_corr_sample(jpyr, jt, jnp.asarray(coords), radius=3))
    got = corr.fused_corr_sample(tpyr, tt, torch.from_numpy(coords), radius=3)
    assert got.dtype == torch.float32 and got.shape == (1, 2, 8, 3 * 49)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("radius", [2, 3])
def test_fused_corr_sample_equals_score_map_path(setup, radius):
    """The gather form equals the reference formulation (score maps, then
    bilinear sampling with zero padding) at any radius."""
    fmaps, targets, coords = setup
    pyr = corr.build_fmap_pyramid(torch.from_numpy(fmaps), 3)
    tt, tc = torch.from_numpy(targets), torch.from_numpy(coords)
    want = corr.sample_corr_pyramid(corr.corr_pyramid(pyr, tt), tc, radius)
    got = corr.fused_corr_sample(pyr, tt, tc, radius)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("map_dt,tgt_dt", PAIRS)
def test_corr_sample_cpu_matches_pallas_interpret(setup, map_dt, tgt_dt):
    fmaps, targets, coords = setup
    jpyr, jt, tpyr, tt = _both(fmaps, targets, coords, map_dt, tgt_dt)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(corr_pallas.corr_sample_pallas(jpyr, jt, jnp.asarray(coords),
                                                         radius=3, tile_n=8))
    before = corr_cuda.launches
    got = corr_cuda.corr_sample(tpyr, tt, torch.from_numpy(coords), radius=3)
    assert corr_cuda.launches == before  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_corr_sample_reads_strided_targets(setup):
    """The model hands the first iteration an expanded (stride-0) target and
    later ones a transposed view; both are read as they are."""
    fmaps, targets, coords = setup
    pyr = corr.build_fmap_pyramid(torch.from_numpy(fmaps), 3)
    base = torch.from_numpy(targets[:, 0])  # (B, N, C)
    expanded = base[:, None].expand(1, 2, 8, 16)
    tc = torch.from_numpy(coords)
    np.testing.assert_array_equal(corr_cuda.corr_sample(pyr, expanded, tc).numpy(),
                                  corr_cuda.corr_sample(pyr, expanded.contiguous(), tc).numpy())


@pytest.mark.parametrize("bad", ["coords_shape", "channels", "level_batch", "level_dtype",
                                 "empty_level"])
def test_corr_sample_rejects_mismatched_inputs(setup, bad):
    fmaps, targets, coords = setup
    pyr = corr.build_fmap_pyramid(torch.from_numpy(fmaps), 3)
    tt, tc = torch.from_numpy(targets), torch.from_numpy(coords)
    if bad == "coords_shape":
        tc = tc[:, :, :5]
    elif bad == "channels":
        tt = tt[..., :8]
    elif bad == "level_batch":
        pyr[1] = pyr[1][:, :1]
    elif bad == "empty_level":
        pyr[2] = pyr[2][:, :, :0]
    else:
        pyr[2] = pyr[2].to(torch.bfloat16)
    with pytest.raises(ValueError):
        corr_cuda.corr_sample(pyr, tt, tc)


# ---- the launch plan (``corr_cuda.launch_plan``), on the host

_SRC = corr_cuda._build.CSRC / "corr_sample_fwd.cu"


def test_corr_plan_constants_are_the_kernels():
    """The plan's warps a block, blocks an SM and shared memory are the
    kernel's (a warp's 8 x 8 f32 scores), its blocks the kernel's launch, and
    the C entry takes its path, levels a warp and grid."""
    src = _SRC.read_text()
    assert "constexpr int kThreads = 256;" in src and corr_cuda.WARPS == 256 // 32
    assert "__shared__ float sg[kWarps][kG * kG];" in src
    assert "__shared__ uint4 stg[kWarps][T::kWords * 32];" in src
    for target, words in (("TargetMma", 2), ("TargetMma3", 6), ("TargetSimt", 2)):
        assert re.search(rf"struct {target} {{\n  static constexpr int (kParts = \d, )?kWords = "
                         rf"{words};", src), target
    assert corr_cuda.SMEM == {1: 8 * (256 + 2 * 512), 2: 8 * (256 + 6 * 512), 0: 8 * (256 + 1024)}
    assert f"__launch_bounds__(kThreads, PIPS_CORR_BLOCKS(TM, TT))\n{corr_cuda.KERNEL}(" in src
    assert "constexpr int kBlocksPerSM = 4;" in src and corr_cuda.FILL <= 4
    assert "const dim3 blocks((N + kWarps - 1) / kWarps, B * S, (L + lpw - 1) / lpw);" in src
    assert ("int path, int lpw, int grid, float scale, int device,\n"
            "                         void* stream)") in src


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("B,S,N,L", [(1, 8, 256, 4), (1, 8, 100, 4), (1, 8, 7680, 4),
                                     (1, 8, 1, 4), (2, 3, 5, 1), (1, 1, 1, 8), (3, 8, 33, 3),
                                     (4, 8, 768, 4)])
def test_corr_launch_plan(pair, B, S, N, L):
    """bf16 maps take the tensor-core paths (an f32 target split in three),
    f32 maps the SIMT one. Block (x, y, z)'s warp w takes point 8 x + w of frame y and levels
    lpw z .. lpw z + lpw - 1 below L: every (frame, point, level) is one
    warp's, once, and the last block's spare warps take none. A warp takes
    all L levels where that still gives the card 3 blocks an SM, else the
    most of (L, half) that does, else one."""
    plan = corr_cuda.launch_plan(B, S, N, L, *(TDT[d] for d in pair), sms=132)
    assert plan.path == {("bfloat16", "bfloat16"): 1, ("bfloat16", "float32"): 2,
                         ("float32", "float32"): 0}[pair]
    assert plan.smem == corr_cuda.SMEM[plan.path] and 4 * plan.smem <= 232_448
    bx = -(-N // corr_cuda.WARPS)
    fills = [k for k in (L, -(-L // 2)) if bx * B * S * -(-L // k) >= 3 * 132]
    assert plan.lpw == (fills[0] if fills else 1)
    assert plan.blocks == (bx, B * S, -(-L // plan.lpw))
    assert plan.grid == bx * B * S * plan.blocks[2]
    taken = [(y, 8 * x + w, lvl) for z in range(plan.blocks[2]) for y in range(B * S)
             for x in range(bx) for w in range(8)
             for lvl in range(plan.lpw * z, min(L, plan.lpw * z + plan.lpw)) if 8 * x + w < N]
    assert len(taken) == len(set(taken)) == B * S * N * L
    assert [corr_cuda.launch_plan(1, 8, 256, 4, torch.bfloat16, torch.bfloat16, sms=132, lpw=k).grid
            for k in (1, 2, 4)] == [1024, 512, 256]
    assert corr_cuda.launch_plan(1, 8, 256, 4, torch.bfloat16, torch.bfloat16, sms=132).lpw == 2


@pytest.mark.parametrize("bad", [dict(L=9), dict(N=0), dict(B=256, S=256), dict(lpw=5),
                                 dict(lpw=0),
                                 dict(map_dtype=torch.float32, tgt_dtype=torch.bfloat16),
                                 dict(map_dtype=torch.float16, tgt_dtype=torch.float16)])
def test_corr_launch_plan_refuses_what_the_kernels_do_not_take(bad):
    args = dict(B=1, S=8, N=4, L=4, map_dtype=torch.bfloat16, tgt_dtype=torch.bfloat16) | bad
    with pytest.raises(ValueError, match="no corr_sample kernel"):
        corr_cuda.launch_plan(**args)
