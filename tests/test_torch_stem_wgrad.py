"""The port's stem weight gradient (``kernels/stem_wgrad_cuda.py``) against the
JAX package's ``stem_wgrad_pallas.stem_wgrad`` and ``stem_conv_s2d``.

JAX runs its Pallas kernel in interpret mode (``interpret_mode``); the port,
on CPU tensors, runs the plain version (per-tap f32 products of the widened
operands). The inputs are the same numpy arrays, NHWC/HWIO for JAX, NCHW and
(O, C, KY, KX) for the port; the port's dk is transposed to JAX's
(KY, KX, C, O). Bounds:

* dk: both sides sum the same products in f32 in other orders (exact
  products for bf16 operands): f32 2e-5 and bf16 1e-4 relative to the
  largest |dk| (K = B*Ho*Wo = 512 terms);
* ``stem_conv_s2d``'s forward: f32 1e-5; bf16 one bf16 ulp at its largest
  magnitude (both round the same f32 sum once); its input cotangent is zero
  on both sides, and its dk is held as above, on the kernel path (Ho = 16)
  and on the library fallback (Ho = 10), where JAX's is XLA's weight-grad
  conv in k2's dtype.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.kernels import stem_wgrad_pallas
from pips_tpu_torch.kernels import stem_wgrad_cuda
from pips_tpu_torch.kernels.stem_wgrad_cuda import (stem_conv_s2d, stem_wgrad,
                                                    stem_wgrad_reference, stem_wgrad_supported)
from pips_tpu_torch.tools import profile_stem_wgrad

DK_TOL = {"float32": 2e-5, "bfloat16": 1e-4}


@functools.lru_cache(maxsize=None)
def _inputs(B: int, H: int, W: int, seed: int = 0):
    """x2 (B, Hp, Wp, 6), k2 (7, 4, 6, 64), dy (B, Ho, Wo, 64), as the JAX tool
    draws them."""
    C, O = 6, 64
    Ho, Wo = H // 2, W // 2
    rng = np.random.RandomState(seed)
    x2 = (rng.rand(B, 2 * Ho + 6, Wo + 3, C) - 0.5).astype(np.float32)
    k2 = (rng.rand(7, 4, C, O) * 0.1 - 0.05).astype(np.float32)
    dy = (rng.rand(B, Ho, Wo, O) - 0.5).astype(np.float32)
    return x2, k2, dy


def _torch(a, dtype, perm):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(*perm))).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _jax_wgrad(B: int, H: int, W: int, dtype: str):
    x2, _, dy = _inputs(B, H, W)
    with stem_wgrad_pallas.interpret_mode():
        dk = stem_wgrad_pallas.stem_wgrad(jnp.asarray(x2, dtype), jnp.asarray(dy, dtype))
    return None if dk is None else np.asarray(dk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_wgrad_matches_jax_kernel(dtype):
    x2, _, dy = _inputs(2, 32, 32)
    want = _jax_wgrad(2, 32, 32, dtype)
    stem_wgrad_cuda.launches = 0
    got = stem_wgrad(_torch(x2, dtype, (0, 3, 1, 2)), _torch(dy, dtype, (0, 3, 1, 2)))
    assert stem_wgrad_cuda.launches == 0  # CPU tensors run the plain version
    assert got.dtype == torch.float32 and got.shape == (64, 6, 7, 4)
    got = got.permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(got, want, atol=DK_TOL[dtype] * np.abs(want).max())


def test_untileable_rows_give_none_on_both_sides():
    x2, _, dy = _inputs(1, 20, 32)  # Ho = 10: no row tile divides it
    assert _jax_wgrad(1, 20, 32, "float32") is None
    assert stem_wgrad(_torch(x2, "float32", (0, 3, 1, 2)),
                      _torch(dy, "float32", (0, 3, 1, 2))) is None
    for Ho, Wo, Wp in ((10, 16, 19), (16, 16, 19), (16, 17, 19), (48, 8, 11)):
        assert stem_wgrad_supported(Ho, Wo, Wp) == stem_wgrad_pallas.stem_wgrad_supported(
            Ho, Wo, Wp)


@functools.lru_cache(maxsize=None)
def _jax_stem_conv(B: int, H: int, W: int, dtype: str):
    x2, k2, dy = _inputs(B, H, W, seed=3)
    x2j, k2j, dyj = (jnp.asarray(a, dtype) for a in (x2, k2, dy))
    with stem_wgrad_pallas.interpret_mode():
        out, vjp = jax.vjp(stem_wgrad_pallas.stem_conv_s2d, x2j, k2j)
        dx2, dk = vjp(dyj)
    return tuple(np.asarray(a, np.float32) for a in (out, dx2, dk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [32, 20], ids=["kernel", "fallback"])
def test_stem_conv_s2d_matches_jax_vjp(H, dtype):
    B, W = 2, 32
    x2, k2, dy = _inputs(B, H, W, seed=3)
    want_out, want_dx2, want_dk = _jax_stem_conv(B, H, W, dtype)
    x2t = _torch(x2, dtype, (0, 3, 1, 2)).requires_grad_(True)
    k2t = _torch(k2, dtype, (3, 2, 0, 1)).requires_grad_(True)
    out = stem_conv_s2d(x2t, k2t)
    out.backward(_torch(dy, dtype, (0, 3, 1, 2)))
    got_out = out.detach().float().permute(0, 2, 3, 1).numpy()
    tol = 1e-5 if dtype == "float32" else 2.0 ** (np.ceil(np.log2(np.abs(want_out).max())) - 8)
    np.testing.assert_allclose(got_out, want_out, atol=tol)
    assert not x2t.grad.any() and not want_dx2.any()
    assert x2t.grad.dtype == x2t.dtype and k2t.grad.dtype == k2t.dtype
    got_dk = k2t.grad.float().permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(got_dk, want_dk, atol=DK_TOL[dtype] * np.abs(want_dk).max()
                               + (0 if dtype == "float32" else
                                  2.0 ** (np.ceil(np.log2(np.abs(want_dk).max())) - 8)))


def test_reference_is_the_library_weight_grad():
    x2, _, dy = _inputs(1, 16, 24, seed=4)
    x2t, dyt = _torch(x2, "float32", (0, 3, 1, 2)), _torch(dy, "float32", (0, 3, 1, 2))
    want = torch.nn.grad.conv2d_weight(x2t, (64, 6, 7, 4), dyt, stride=(2, 1))
    torch.testing.assert_close(stem_wgrad_reference(x2t, dyt), want, rtol=1e-5, atol=1e-5)


def test_tool_runs_on_cpu_when_asked():
    stem_wgrad_cuda.launches = 0
    res = profile_stem_wgrad.run(1, 32, 48, "float32", "tiny", device="cpu", rounds=1, reps=1)
    assert res["rel"] < 1e-5 and res["x7_diff"] < 1e-5
    for mode in ("fwd", "fwd+dk"):
        for name in ("library", "kernel", "x7"):
            assert res[f"{mode} {name}"] > 0
    assert stem_wgrad_cuda.launches == 0


# the f32 kernel's launch at the smoke's shapes: B=1 and B=8 at 384x512, the
# small f32 case (2x64x96) and a row that no segment width divides (Wo = 164)
F32_PLAN_SHAPES = [(1, 192, 256), (8, 192, 256), (2, 32, 48), (2, 96, 164)]


@pytest.mark.parametrize("B,Ho,Wo", F32_PLAN_SHAPES, ids=lambda v: str(v))
def test_f32_plan_covers_every_pixel_once(B, Ho, Wo):
    """Every (b, h, w') pixel falls in exactly one segment of exactly one block
    of ``f32_plan``'s launch, as the kernel walks the segments; the segments
    fit the kernel's stage and there is one block an SM, at most one a
    segment."""
    sms = 132
    plan = stem_wgrad_cuda.f32_plan(B, Ho, Wo, sms)
    assert 1 <= plan.seg <= stem_wgrad_cuda.F32_SEG
    assert plan.segs_w == -(-Wo // plan.seg) and plan.nseg == B * Ho * plan.segs_w
    assert plan.blocks == min(plan.nseg, sms)
    hits = np.zeros((B * Ho, Wo), np.int64)
    for block in range(plan.blocks):  # as csrc/stem_wgrad.cu's stem_wgrad_f32 walks them
        s0, s1 = plan.nseg * block // plan.blocks, plan.nseg * (block + 1) // plan.blocks
        assert s1 > s0  # no block idles
        for s in range(s0, s1):
            w0 = s % plan.segs_w * plan.seg
            w1 = min(w0 + plan.seg, Wo)
            assert 0 < w1 - w0 <= plan.seg
            hits[s // plan.segs_w, w0:w1] += 1
    assert (hits == 1).all()


def test_f32_plan_fills_the_card_at_small_shapes():
    """Rows are split while the segments number fewer than two an SM, down
    to 16 columns: the small case (64 rows of 48 columns) gets 128 blocks of
    one 24-column segment; B=1 at 384x512 keeps 384 segments of 128 columns."""
    assert stem_wgrad_cuda.f32_plan(2, 32, 48, 132) == (24, 2, 128, 128)
    assert stem_wgrad_cuda.f32_plan(1, 192, 256, 132) == (128, 2, 384, 132)
    assert stem_wgrad_cuda.f32_plan(8, 192, 256, 132) == (128, 2, 3072, 132)
    assert stem_wgrad_cuda.f32_plan(1, 8, 20, 132) == (20, 1, 8, 8)  # no split below 16


def test_tool_times_the_weight_gradient_only_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_stem_wgrad.cli(["--wgrad", "--dtype", "float32"])
