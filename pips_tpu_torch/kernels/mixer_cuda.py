"""Fused MLP-Mixer channel block ``y = x + fc2(gelu(fc1(LN(x))))`` for Hopper.

Counterpart of ``pips_tpu/kernels/mixer_pallas.py``: ``chan_ff_block`` has the
JAX signature and launches the hand-written CUDA kernel in
``pips_tpu_torch/csrc/chanff_fwd.cu`` (which replaces the TPU kernel
``_chanff_fwd``; the source's header says what bounds it and how its design
answers that). ``chan_ff_reference`` is the plain PyTorch version, a
transcription of the JAX ``chan_ff_reference``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. There is no backward: the kernel serves inference only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pips_tpu_torch.kernels import _build

_SQRT2 = math.sqrt(2.0)
KERNEL_D = 512      # channel width the kernel is compiled for
KERNEL_F_MULT = 64  # F must be a multiple of the kernel's F chunk

launches = 0  # kernel launches so far; read (and reset) by chip_smoke.py
_fn = None


def chan_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Plain PyTorch block with flax LayerNorm(f32) + Dense(x.dtype) semantics.

    x: (R, D); returns (R, D) in x.dtype. LN statistics in f32 with
    var = E[x^2] - mu^2 clamped at 0; matmuls in x's dtype, whose outputs (as
    in the JAX reference) are in x's dtype before the f32 bias; exact-erf GELU
    and the residual in f32.
    """
    cd = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    xa = xn * ln_scale.float() + ln_bias.float()
    a1 = torch.matmul(xa.to(cd), w1.to(cd)).float() + b1.float()
    g1 = 0.5 * a1 * (1.0 + torch.erf(a1 / _SQRT2))
    o = torch.matmul(g1.to(cd), w2.to(cd)).float() + b2.float()
    return (xf + o).to(cd)


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (R, D) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    R, D = x.shape
    F = w1.shape[-1]
    want = {"ln_scale": (ln_scale, (D,), torch.float32), "ln_bias": (ln_bias, (D,), torch.float32),
            "w1": (w1, (D, F), x.dtype), "b1": (b1, (F,), torch.float32),
            "w2": (w2, (F, D), x.dtype), "b2": (b2, (D,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return R, D, F


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("chanff_fwd").pips_chanff_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chan_ff_block(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Fused channel block. x: (R, D) float32/bfloat16; w1 (D, F) and w2 (F, D)
    in x's dtype; ln_scale, ln_bias, b1, b2 float32. Returns (R, D) in x.dtype.

    On CUDA the kernel takes D == 512, F a multiple of 64 and contiguous,
    16-byte-aligned tensors; anything else raises.
    """
    global launches
    R, D, F = _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return chan_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_block runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, w1, b1, w2, b2)):
        raise RuntimeError("chan_ff_block's CUDA kernel has no backward; "
                           "call it under torch.no_grad()")
    if D != KERNEL_D or F % KERNEL_F_MULT or R == 0:
        raise ValueError(f"CUDA chan_ff_block takes D={KERNEL_D}, F % {KERNEL_F_MULT} == 0, "
                         f"R > 0; got R={R} D={D} F={F}")
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    for t in args:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("chan_ff_block's CUDA kernel needs contiguous, 16-byte aligned inputs")
    y = torch.empty_like(x)
    err = _kernel()(*(t.data_ptr() for t in args), y.data_ptr(), R, D, F,
                    int(x.dtype == torch.bfloat16), x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return y
