"""F-chunked MLP-Mixer channel block ``y = x + fc2(gelu(fc1(LN(x))))`` for Hopper.

Counterpart of ``tools/profile_chanff_chunk.py``'s ``make_chunked(fc)``: the
channel block with F walked in static chunks of ``fc`` columns, forward and
backward, with the JAX custom VJP's contract (``chan_ff_block_chunked``). On
a bf16 CUDA tensor the forward launches ``csrc/chanff_chunk.cu:chanff_chunk_fwd``
(which replaces the TPU kernel of ``make_chunked``'s fwd, :121) and the
backward ``chanff_chunk_bwd_rows`` (its bwd, :149), finished by
``csrc/chanff_bwd.cu``'s weight-grad GEMMs and ordered column sums.

``chan_ff_chunked_reference`` and ``chan_ff_chunked_bwd_reference`` are the
plain versions, transcriptions of ``_fwd_kernel_chunked`` and
``_bwd_kernel_chunked``: the fc1 and fc2 products stay in f32 with the f32
bias, o and dxa accumulate chunk by chunk in f32, and y is rounded once. That
is not ``mixer_cuda.chan_ff_reference``, which rounds the products to x's
dtype before the bias, as the flax model does.

A CPU tensor goes to the plain versions, in f32 or bf16. A CUDA tensor
launches the kernels or raises. In bf16 those are ``chanff_chunk.cu``'s, at
the widths in ``FCS``. In f32 they are ``mixer_cuda``'s f32 SIMT kernels
(``csrc/chanff_fwd.cu``, and ``chanff_bwd.cu``'s ``rows32`` / ``wgrad32``),
at any fc that divides F: with ``cdtype = f32`` every cast to the compute
dtype in ``_fwd_kernel_chunked`` and ``_bwd_kernel_chunked`` is the
identity, so chunking F rounds nothing, and the f32 chunked block is the f32
monolithic block with its sums taken in another order. Those launches count
in ``mixer_cuda.launches`` and ``mixer_cuda.bwd_f32_launches``, not here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pips_tpu_torch.kernels import _build, mixer_cuda

FCS = (128, 256, 512, 1024)  # chunk widths the kernels are compiled for
_SQRT2 = math.sqrt(2.0)

launches = 0      # forward kernel launches so far; read (and reset) by chip_smoke.py
bwd_launches = 0  # backward launches so far (phase A and the finishing launches)
_fns: dict[str, object] = {}
# C entry of csrc/chanff_chunk.cu -> pointer arguments; each then takes R, D,
# F, fc and the device index, and a stream pointer
_ENTRIES = {"pips_chanff_chunk_fwd": 8, "pips_chanff_chunk_bwd_rows": 13}


def chan_ff_chunked_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *, fc: int):
    """Plain PyTorch ``_fwd_kernel_chunked``: x (R, D) in the compute dtype,
    w1 (D, F) and w2 (F, D) cast to it, f32 vectors; returns (R, D) in x's
    dtype. LN statistics in f32 (var = E[x^2] - mu^2 clamped at 0); per chunk
    of ``fc`` columns, a1 = xa_c @ w1 chunk (f32 sums of the compute-dtype
    products) + b1, exact-erf GELU, and o += gelu_c @ w2 chunk in f32; then
    y = x + o + b2, rounded once."""
    cd = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    xa_c = (xn * ln_scale.float() + ln_bias.float()).to(cd)
    w1, w2 = w1.to(cd), w2.to(cd)
    o = torch.zeros_like(xf)
    for f in range(0, w1.shape[1], fc):
        a1 = mixer_cuda._mm(xa_c, w1[:, f:f + fc]) + b1[f:f + fc].float()
        g1 = 0.5 * a1 * (1.0 + torch.erf(a1 / _SQRT2))
        o = o + mixer_cuda._mm(g1.to(cd), w2[f:f + fc])
    return (xf + o + b2.float()).to(cd)


def chan_ff_chunked_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, *, fc: int):
    """Plain PyTorch ``_bwd_kernel_chunked``: ``chan_ff_bwd_reference``'s
    contract and math with dxa summed chunk by chunk in f32 (every other grad
    is a sum over rows, the same whether F is chunked or not)."""
    return mixer_cuda.chan_ff_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=fc)


def _check_fc(x, w1, fc) -> None:
    F = w1.shape[-1]
    if not isinstance(fc, int) or fc <= 0 or F % fc:
        raise ValueError(f"fc must be a positive divisor of F={F}, got {fc!r}")
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and fc not in FCS:
        raise ValueError(f"the CUDA bf16 chunked channel block takes fc in {FCS}, got {fc}")


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/chanff_chunk.cu`` (built at first use), typed."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("chanff_chunk"), name)
        fn.argtypes = [ctypes.c_void_p] * _ENTRIES[name] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, fc: int):
    """The block's value: the plain version on a CPU tensor, the kernel on
    CUDA. w1, w2 are in x's dtype here."""
    global launches
    if x.device.type == "cpu":
        return chan_ff_chunked_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, fc=fc)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_block_chunked runs on cpu or cuda, not {x.device}")
    if x.dtype == torch.float32:  # chunking F rounds nothing in f32: the monolithic kernel
        return mixer_cuda._forward(x, ln_scale, ln_bias, w1, b1, w2, b2)
    R, D = x.shape
    F = w1.shape[1]
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    mixer_cuda._cuda_ready("chan_ff_block_chunked", args, R, D, F)
    y = torch.empty_like(x)
    err = _kernel("pips_chanff_chunk_fwd")(*(t.data_ptr() for t in args), y.data_ptr(), R, D, F,
                                           fc, x.device.index,
                                           torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_chunk_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def chan_ff_chunked_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, *, fc: int):
    """Gradients of the chunked block: ``chan_ff_chunked_bwd_reference``'s
    contract. On a bf16 CUDA tensor it launches ``chanff_chunk_bwd_rows`` and
    then ``chanff_bwd.cu``'s phases B and C, on an f32 one
    ``mixer_cuda.chan_ff_bwd``'s f32 kernel; on a CPU tensor it runs the plain
    version."""
    global bwd_launches
    if x.device.type == "cpu":
        return chan_ff_chunked_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=fc)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_chunked_bwd runs on cpu or cuda, not {x.device}")
    _check_fc(x, w1, fc)
    if x.dtype == torch.float32:  # as in _forward: the monolithic f32 backward kernel
        return mixer_cuda.chan_ff_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2)
    R, D = x.shape
    F = w1.shape[1]
    args = (x, dy, ln_scale, ln_bias, w1, b1, w2)
    if dy.shape != x.shape or dy.dtype != x.dtype or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError("dy, w1 and w2 must be in x's dtype, dy of x's shape")
    mixer_cuda._cuda_ready("chan_ff_chunked_bwd", args, R, D, F)
    outs, scratch = mixer_cuda.bwd_buffers(x, F)
    dev = x.device
    err = _kernel("pips_chanff_chunk_bwd_rows")(
        *(t.data_ptr() for t in args + outs[:1] + scratch), R, D, F, fc, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_chunk_bwd_rows kernel launch failed: CUDA error {err}")
    mixer_cuda.bwd_finish(dy, outs, scratch)
    bwd_launches += 1
    return outs


class _ChunkFF(torch.autograd.Function):
    """The custom VJP of ``tools/profile_chanff_chunk.py:make_chunked(fc)``."""

    @staticmethod
    def forward(ctx, fc, x, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.fc = fc
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, fc)

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dx, dg, db, dw1, db1, dw2, db2 = chan_ff_chunked_bwd(
            x, dy.to(x.dtype).contiguous(), ln_scale, ln_bias, w1.to(x.dtype), b1,
            w2.to(x.dtype), fc=ctx.fc)
        # weight grads in the weights' own dtype: f32 for f32 parameters, as in JAX
        return None, dx, dg, db, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def chan_ff_block_chunked(x, ln_scale, ln_bias, w1, b1, w2, b2, *, fc: int):
    """F-chunked channel block: ``mixer_cuda.chan_ff_block``'s signature and
    weight conventions (w1, w2 in x's dtype or f32, cast inside), F walked in
    chunks of ``fc`` columns, which must divide F. Returns (R, D) in x.dtype,
    with a gradient when any input requires one.

    On CUDA the kernels take D == 512, contiguous, 16-byte-aligned tensors,
    and in bf16 fc in ``FCS``; anything else raises.
    """
    mixer_cuda._check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    _check_fc(x, w1, fc)
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ChunkFF.apply(fc, *args)
    return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, fc)
