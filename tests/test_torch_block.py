"""The port's fused stage-1 residual block (``kernels/block_cuda.py``) against
the JAX package's ``block_pallas.res_block64`` and ``_conv_pass``.

JAX runs its Pallas kernel in interpret mode (``interpret_mode``, as
``tests/test_block_kernel.py`` does); the port, on CPU tensors, runs the
plain conv pass inside the same hand-written backward. The inputs are the
same numpy arrays, NHWC/HWIO for JAX and NCHW/OIHW for the port. Bounds:

* f32 at (2, 16, 32, 64), ``test_block_kernel.py``'s bounds: forward 2e-4,
  grads of sum(sin(out)) 3e-3 * max(|ref|, 1), both db below 1e-4 (the
  instance norm removes the conv bias, so its grad is zero in exact math);
* bf16 at that shape: forward and the grads of x, w1, w2 within 4 bf16 ulps
  at their largest magnitude (``_ulp`` is two ulps there). Both sides round
  y1, the pass-2 input, y2, the output and the cotangents to bf16 at the
  same places, from f32 values that differ in summation order, so each may
  flip a rounding; measured: half of one ``_ulp``. Each db is bf16 rounding
  noise around zero: held below 1% of the largest weight grad (measured
  0.1%);
* ``conv_pass_reference`` against ``_conv_pass``: y 1e-4 in f32 (a 576-term
  f32 sum in two orders), stats relative 1e-5 (f32 sums over 512 pixels);
  with the prologue, the border pixels too, under a positive shift that a
  padding read as relu(shift) would show;
* ``res_block64_reference`` against the port's modular ``ResidualBlock``
  (cuDNN-style convs, ``instance_norm``, autograd) in f32: output 2e-5,
  grads 1e-4 relative to the largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.kernels import block_pallas, conv_pallas
from pips_tpu.kernels.block_pallas import interpret_mode
from pips_tpu.kernels.block_pallas import res_block64 as jax_res_block64
from pips_tpu_torch.kernels import block_cuda
from pips_tpu_torch.kernels.block_cuda import (conv_pass, conv_pass_reference, res_block64,
                                               res_block64_reference)
from pips_tpu_torch.models.encoder import ResidualBlock
from pips_tpu_torch.tools import profile_block_kernel

SHAPE = (2, 16, 32, 64)
GRADS = ("dx", "dw1", "db1", "dw2", "db2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_conv.py does
    (this torch build's multi-threaded CPU conv backward can abort)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _args():
    rng = np.random.RandomState(0)
    B, H, W, C = SHAPE
    x = rng.randn(B, H, W, C).astype(np.float32)
    w1 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, C, C) * 0.1).astype(np.float32)
    b1 = (rng.randn(C) * 0.1).astype(np.float32)
    b2 = (rng.randn(C) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@functools.lru_cache(maxsize=None)
def _jax_block(dtype: str):
    """JAX's output and the grads of sum(sin(out)), once per dtype."""
    x, w1, b1, w2, b2 = map(jnp.asarray, _args())

    def run(x, w1, b1, w2, b2):
        return jax_res_block64(x.astype(dtype), w1, b1, w2, b2)

    def loss(*a):
        return jnp.sum(jnp.sin(run(*a).astype(jnp.float32)))

    with interpret_mode():
        out = run(x, w1, b1, w2, b2)
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x, w1, b1, w2, b2)
    return np.asarray(out, np.float32), tuple(np.asarray(g, np.float32) for g in grads)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _ulp(a) -> float:
    return 2.0 ** (np.ceil(np.log2(np.abs(a).max())) - 7)


def _port_block(fn, dtype: str):
    """fn's output (NHWC, f32) and grads of sum(sin(out)) in JAX's layouts."""
    x, w1, b1, w2, b2 = _args()
    xt = _nchw(x).requires_grad_(True)
    w1t, w2t = _oihw(w1).requires_grad_(True), _oihw(w2).requires_grad_(True)
    b1t, b2t = torch.from_numpy(b1).requires_grad_(True), torch.from_numpy(b2).requires_grad_(True)
    out = fn(xt.to(getattr(torch, dtype)), w1t, b1t, w2t, b2t)
    assert out.dtype == getattr(torch, dtype) and out.shape == xt.shape
    torch.sin(out.float()).sum().backward()
    grads = (xt.grad.permute(0, 2, 3, 1), w1t.grad.permute(2, 3, 1, 0), b1t.grad,
             w2t.grad.permute(2, 3, 1, 0), b2t.grad)
    return (out.detach().float().permute(0, 2, 3, 1).numpy(),
            tuple(g.float().numpy() for g in grads))


def test_block_f32_matches_jax_kernel():
    want_out, want = _jax_block("float32")
    block_cuda.launches = 0
    out, got = _port_block(res_block64, "float32")
    assert block_cuda.launches == 0  # CPU tensors run the plain version
    np.testing.assert_allclose(out, want_out, atol=2e-4)
    for name, a, b in zip(GRADS, got, want):
        scale = max(float(np.abs(b).max()), 1.0)
        assert np.abs(a - b).max() < 3e-3 * scale, (name, np.abs(a - b).max(), scale)
    for db in (got[2], want[2], got[4], want[4]):
        assert np.abs(db).max() < 1e-4


def test_block_bf16_matches_jax_kernel():
    want_out, want = _jax_block("bfloat16")
    out, got = _port_block(res_block64, "bfloat16")
    assert np.abs(out - want_out).max() <= 4 * _ulp(want_out)
    for name, a, b in zip(GRADS, got, want):
        if name.startswith("db"):
            continue
        assert np.abs(a - b).max() <= 4 * _ulp(b), (name, np.abs(a - b).max(), _ulp(b))
    dw_max = max(np.abs(want[1]).max(), np.abs(want[3]).max())
    for db in (got[2], want[2], got[4], want[4]):
        assert np.abs(db).max() < 1e-2 * dw_max


def _s2d_aff(aff):
    """(B, 2, C) logical [scale; shift] -> JAX's s2d (B, 2, 2C)."""
    return np.concatenate([aff, aff], axis=-1)


@functools.lru_cache(maxsize=None)
def _jax_conv_pass(prologue: bool):
    """JAX ``_conv_pass`` on the s2d tensors, back in logical NHWC: y and the
    (B, 2, C) stats (the two s2d halves of each channel summed)."""
    x, w1, b1, _, _ = _args()
    aff = _aff()
    B, H, W, C = x.shape
    W2, C2 = W // 2, 2 * C
    W2p = -(-(W2 + 2) // 8) * 8
    x2 = jnp.asarray(x).reshape(B, H, W2, C2)
    wf = conv_pallas._pack_weights(jnp.asarray(w1), C)
    br = jnp.concatenate([jnp.asarray(b1)] * 2).reshape(1, C2)
    with interpret_mode():
        y, st = block_pallas._conv_pass(block_pallas._pad_s2d(x2, W2p), wf, br,
                                        jnp.asarray(_s2d_aff(aff)), B=B, H=H, W2=W2, C2=C2,
                                        O2=C2, prologue=prologue, out_dtype=jnp.float32)
    st = np.asarray(st)
    return np.asarray(y).reshape(B, H, W, C), st[..., :C] + st[..., C:]


def _aff():
    """A per-image [scale; shift] whose shift is positive everywhere, so that
    a SAME border padded with relu(shift) would differ from zeros."""
    rng = np.random.RandomState(5)
    B, C = SHAPE[0], SHAPE[3]
    return np.stack([0.5 + rng.rand(B, C), 0.2 + 0.3 * rng.rand(B, C)], axis=1).astype(np.float32)


@pytest.mark.parametrize("prologue", [False, True])
def test_conv_pass_reference_matches_jax(prologue):
    x, w1, b1, _, _ = _args()
    want_y, want_st = _jax_conv_pass(prologue)
    args = (_nchw(x), _oihw(w1), torch.from_numpy(b1), torch.from_numpy(_aff()), prologue)
    y, st = conv_pass_reference(*args)
    for a, b in zip(conv_pass(*args), (y, st)):  # a CPU tensor runs the plain version
        assert torch.equal(a, b)
    assert y.dtype == torch.float32 and st.shape == (x.shape[0], 2, x.shape[3])
    y = y.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, want_y, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), want_st, rtol=1e-5, atol=1e-5 * np.abs(want_st).max())
    border = np.zeros(y.shape[1:3], bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    np.testing.assert_allclose(y[:, border], want_y[:, border], atol=1e-4)
    if prologue:  # the border must see zero padding, not relu(shift)
        xf = torch.from_numpy(x).permute(0, 3, 1, 2)
        a = torch.from_numpy(_aff())
        band = (torch.nn.functional.pad(xf, (1, 1, 1, 1)) * a[:, 0, :, None, None]
                + a[:, 1, :, None, None]).clamp_min(0.0)
        leaky = torch.nn.functional.conv2d(band, _oihw(w1), torch.from_numpy(b1))
        assert np.abs(leaky.permute(0, 2, 3, 1).numpy()[:, border] - want_y[:, border]).max() > 1e-2


def test_reference_matches_modular_residual_block():
    """``res_block64_reference`` (statistics from the conv pass, the
    hand-written backward) against ``ResidualBlock(64, 64, 1)`` with autograd."""
    x, w1, b1, w2, b2 = _args()
    blk = ResidualBlock(64, 64, 1)
    with torch.no_grad():
        blk.conv1.weight.copy_(_oihw(w1))
        blk.conv1.bias.copy_(torch.from_numpy(b1))
        blk.conv2.weight.copy_(_oihw(w2))
        blk.conv2.bias.copy_(torch.from_numpy(b2))
    xm = _nchw(x).requires_grad_(True)
    out_m = blk(xm)
    torch.sin(out_m).sum().backward()
    want = (xm.grad.permute(0, 2, 3, 1), blk.conv1.weight.grad.permute(2, 3, 1, 0),
            blk.conv1.bias.grad, blk.conv2.weight.grad.permute(2, 3, 1, 0), blk.conv2.bias.grad)
    out, got = _port_block(res_block64_reference, "float32")
    np.testing.assert_allclose(out, out_m.detach().permute(0, 2, 3, 1).numpy(), atol=2e-5)
    for name, a, b in zip(GRADS, got, want):
        b = b.numpy()
        scale = max(float(np.abs(b).max()), 1.0)
        assert np.abs(a - b).max() < 1e-4 * scale, (name, np.abs(a - b).max(), scale)


def test_tool_runs_on_cpu_when_asked():
    block_cuda.launches = 0
    res = profile_block_kernel.main(B=1, H=8, W=16, dtype="float32", device="cpu", rounds=1,
                                    reps=1)
    assert set(res) >= {"fwd_xla", "fwd_kernel", "bwd_xla", "bwd_kernel"}
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert block_cuda.launches == 0
