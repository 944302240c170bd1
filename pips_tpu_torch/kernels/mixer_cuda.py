"""Fused MLP-Mixer channel block ``y = x + fc2(gelu(fc1(LN(x))))`` for Hopper.

Counterpart of ``pips_tpu/kernels/mixer_pallas.py``: ``chan_ff_block`` has the
JAX signature and its gradient. On a CUDA tensor the forward launches the
hand-written kernel in ``pips_tpu_torch/csrc/chanff_fwd.cu`` (which replaces
the TPU kernel ``_chanff_fwd``) and the backward the one in
``csrc/chanff_bwd.cu`` (which replaces ``_chanff_bwd``), in bf16 on the tensor
cores and in f32 on SIMT FMAs; each source's header says what bounds it and
how its design answers that. ``chan_ff_reference``
and ``chan_ff_bwd_reference`` are their plain PyTorch versions, transcriptions
of the JAX kernels' math.

A CPU tensor goes to the plain versions; a CUDA tensor launches the kernels or
raises. Like the JAX custom VJP, the forward saves x (and the parameters it
was given) and the backward recomputes the activations from x.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pips_tpu_torch.kernels import _build

_SQRT2 = math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
KERNEL_D = 512      # channel width the kernels are compiled for
KERNEL_F_MULT = 64  # F must be a multiple of the kernels' F chunk

launches = 0          # forward kernel launches so far; read (and reset) by chip_smoke.py
bwd_launches = 0      # bf16 backward kernel launches so far
bwd_f32_launches = 0  # f32 backward kernel launches so far
_fns: dict[str, object] = {}


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


def _mm(a, b):
    """Product of two compute-dtype operands accumulated in f32 (bf16 products
    are exact in f32, so an f32 matmul of the widened operands is that)."""
    return torch.matmul(a.float(), b.float())


def chan_ff_bwd_terms(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=None) -> dict:
    """The plain backward's intermediates, widened to f32: xn and rsig of the
    LN; xa_c, g1_c, dy (the compute-dtype operands of the weight-grad
    products, as rounded); da1 and its rounding da1_c; dxa = da1_c @ w1^T,
    summed in f32 over F chunks of ``fc`` columns when ``fc`` is given (the
    JAX chunked kernel's order). ``chan_ff_bwd_reference`` sums these into
    the grads."""
    cd = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rsig = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    xn = (xf - mu) * rsig
    xa_c = (xn * ln_scale.float() + ln_bias.float()).to(cd).float()
    a1 = _mm(xa_c, w1) + b1.float()
    g1_c = (0.5 * a1 * (1.0 + torch.erf(a1 / _SQRT2))).to(cd).float()
    dy = dy.to(cd).float()
    dg1 = _mm(dy, w2.t())
    phi = torch.exp(-0.5 * a1 * a1) * _INV_SQRT2PI
    da1 = dg1 * (0.5 * (1.0 + torch.erf(a1 / _SQRT2)) + a1 * phi)
    da1_c = da1.to(cd).float()
    if fc is None:
        dxa = _mm(da1_c, w1.t())
    else:
        dxa = sum(_mm(da1_c[:, f:f + fc], w1[:, f:f + fc].t()) for f in range(0, w1.shape[1], fc))
    return dict(xn=xn, rsig=rsig, xa_c=xa_c, g1_c=g1_c, dy=dy, da1=da1, da1_c=da1_c, dxa=dxa)


def chan_ff_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=None):
    """Plain PyTorch backward of the block, the JAX ``_chanff_bwd_kernel``'s math.

    x, dy: (R, D) in the compute dtype (x's); w1 (D, F), w2 (F, D) in x's
    dtype; ln_scale, ln_bias, b1 f32. Returns (dx in x's dtype, and f32
    d ln_scale, d ln_bias, dw1, db1, dw2, db2). The forward is recomputed from
    x; the four products take operands rounded to the compute dtype (xa_c,
    g1_c, da1_c, dy_c) and accumulate in f32; db1, db2 and the LN grads are
    summed in f32 from unrounded values. Not autograd of ``chan_ff_reference``,
    which would round dw1 and dw2 to the compute dtype. With ``fc``, the JAX
    chunked kernel's backward (``tools/profile_chanff_chunk.py``): dxa summed
    chunk by chunk; every other grad is the same sum.
    """
    t = chan_ff_bwd_terms(x, dy, ln_scale, ln_bias, w1, b1, w2, fc)
    xn, dxa = t["xn"], t["dxa"]
    dxn = dxa * ln_scale.float()
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    dx = (t["dy"] + t["rsig"] * (dxn - m1 - xn * m2)).to(x.dtype)
    return (dx, (dxa * xn).sum(0), dxa.sum(0), _mm(t["xa_c"].t(), t["da1_c"]), t["da1"].sum(0),
            _mm(t["g1_c"].t(), t["dy"]), t["dy"].sum(0))


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (R, D) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    R, D = x.shape
    F = w1.shape[-1]
    weight = (x.dtype, torch.float32)  # weights are cast to x's dtype, as JAX's _prep does
    want = {"ln_scale": (ln_scale, (D,), (torch.float32,)),
            "ln_bias": (ln_bias, (D,), (torch.float32,)), "w1": (w1, (D, F), weight),
            "b1": (b1, (F,), (torch.float32,)), "w2": (w2, (F, D), weight),
            "b2": (b2, (D,), (torch.float32,))}
    for name, (t, shape, dtypes) in want.items():
        if tuple(t.shape) != shape or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {shape} in one of {dtypes}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return R, D, F


# C entry -> (library stem, pointer arguments, int arguments); each ends in
# the device index and a stream pointer
_ENTRIES = {"pips_chanff_fwd": ("chanff_fwd", 8, 4), "pips_chanff_bwd": ("chanff_bwd", 19, 4),
            "pips_chanff_bwd_finish": ("chanff_bwd", 12, 3)}


def _kernel(name: str):
    """The C entry ``name`` of its library (built at first use), typed."""
    fn = _fns.get(name)
    if fn is None:
        stem, n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load(stem), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _cuda_ready(name: str, tensors, R: int, D: int, F: int) -> None:
    if D != KERNEL_D or F % KERNEL_F_MULT or R == 0:
        raise ValueError(f"CUDA {name} takes D={KERNEL_D}, F % {KERNEL_F_MULT} == 0, "
                         f"R > 0; got R={R} D={D} F={F}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}'s CUDA kernel needs contiguous, 16-byte aligned inputs")


def _forward(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The block's value: the plain version on a CPU tensor, the kernel on CUDA.
    w1, w2 are in x's dtype here."""
    global launches
    if x.device.type == "cpu":
        return chan_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_block runs on cpu or cuda, not {x.device}")
    R, D = x.shape
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    _cuda_ready("chan_ff_block", args, R, D, w1.shape[1])
    y = torch.empty_like(x)
    err = _kernel("pips_chanff_fwd")(*(t.data_ptr() for t in args), y.data_ptr(), R, D,
                                     w1.shape[1], int(x.dtype == torch.bfloat16), x.device.index,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def chan_ff_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2):
    """Gradients of the block: ``chan_ff_bwd_reference``'s contract. On a CUDA
    tensor it launches ``csrc/chanff_bwd.cu`` (its bf16 kernel for a bf16 x,
    its f32 kernel for an f32 x), on a CPU tensor it runs the plain version."""
    global bwd_launches, bwd_f32_launches
    if x.device.type == "cpu":
        return chan_ff_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_bwd runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA backward of chan_ff_block takes bfloat16 or float32, "
                         f"not {x.dtype}")
    R, D = x.shape
    F = w1.shape[1]
    args = (x, dy, ln_scale, ln_bias, w1, b1, w2)
    if dy.shape != x.shape or dy.dtype != x.dtype or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError("dy, w1 and w2 must be in x's dtype, dy of x's shape")
    _cuda_ready("chan_ff_bwd", args, R, D, F)
    outs, scratch = bwd_buffers(x, F)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    err = _kernel("pips_chanff_bwd")(*(t.data_ptr() for t in args + outs + scratch), R, D, F,
                                     int(bf16), dev.index,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_bwd kernel launch failed: CUDA error {err}")
    if bf16:
        bwd_launches += 1
    else:
        bwd_f32_launches += 1
    return outs


def bwd_buffers(x, F: int):
    """The backward's outputs (dx in x's dtype; f32 d ln_scale, d ln_bias, dw1,
    db1, dw2, db2) and the kernel's scratch: xa (R, D), g1 and da1 (R, F) in
    x's dtype, f32 per-block partials (nblk, 3, D) and (nblk, F) over the
    kernel's 16-row blocks (``pips_chanff_bwd_blocks``)."""
    R, D = x.shape
    nblk = -(-R // 16)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dg, db, db2 = (torch.empty(D, **f32) for _ in range(3))
    dw1, db1, dw2 = torch.empty(D, F, **f32), torch.empty(F, **f32), torch.empty(F, D, **f32)
    xa_s = torch.empty(R, D, dtype=x.dtype, device=dev)
    g1_s, da1_s = (torch.empty(R, F, dtype=x.dtype, device=dev) for _ in range(2))
    part_d, part_f = torch.empty(nblk, 3, D, **f32), torch.empty(nblk, F, **f32)
    return ((torch.empty_like(x), dg, db, dw1, db1, dw2, db2),
            (xa_s, g1_s, da1_s, part_d, part_f))


def bwd_finish(dy, outs, scratch) -> None:
    """Phases B and C of ``csrc/chanff_bwd.cu`` (the weight-grad GEMMs over R
    and the partials' ordered column sums) on bf16 scratch in ``bwd_buffers``'
    layout that another phase A filled; writes ``outs``' f32 grads."""
    _, dg, db, dw1, db1, dw2, db2 = outs
    xa_s, g1_s, da1_s, part_d, part_f = scratch
    dev = dy.device
    err = _kernel("pips_chanff_bwd_finish")(
        *(t.data_ptr() for t in (xa_s, g1_s, da1_s, dy, dg, db, dw1, db1, dw2, db2, part_d,
                                 part_f)),
        dy.shape[0], dw1.shape[1], part_f.shape[0], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_bwd finishing launches failed: CUDA error {err}")


class _ChanFF(torch.autograd.Function):
    """The custom VJP of ``pips_tpu/kernels/mixer_pallas.py:chan_ff_block``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2)

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dx, dg, db, dw1, db1, dw2, db2 = chan_ff_bwd(
            x, dy.to(x.dtype).contiguous(), ln_scale, ln_bias, w1.to(x.dtype), b1,
            w2.to(x.dtype))
        # weight grads in the weights' own dtype: f32 for f32 parameters, as in JAX
        return dx, dg, db, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def chan_ff_block(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Fused channel block. x: (R, D) float32/bfloat16; w1 (D, F) and w2 (F, D)
    in x's dtype or float32 (cast to x's dtype inside, so their grads stay in
    their own dtype); ln_scale, ln_bias, b1, b2 float32. Returns (R, D) in
    x.dtype, with a gradient when any input requires one.

    On CUDA the kernels take D == 512, F a multiple of 64 and contiguous,
    16-byte-aligned tensors; anything else raises.
    """
    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ChanFF.apply(*args)
    return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2)
