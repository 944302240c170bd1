"""The MLP-Mixer token block ``y = x + (gelu(LN(x)^T w1 + b1) w2 + b2)^T`` for Hopper.

The token half of each ``models.mixer.MLPMixer`` block: a LayerNorm over the
D channels of each token, then the feed-forward across each point's S tokens
(S -> 4S -> S), then the residual. ``pips_tpu/`` has no kernel for it (XLA
fuses its ``jnp`` ops), so the port's hand-written one,
``pips_tpu_torch/csrc/token_ff.cu`` (whose header says what bounds it and
how its design answers that), replaces no ``pallas_call``. It is a forward
at the published shape (``KERNEL_SHAPE``, in bf16 or f32). Given a CPU
tensor, ``token_mix_block`` runs ``token_mix_reference``, the plain version
and the block's only definition; given a CUDA tensor, it launches the kernel
or raises. ``takes_kernel`` says which calls the kernel serves: while
autograd records (training, remat's recompute) and at other shapes, the
caller calls ``token_mix_reference`` by name.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels import _build
from pips_tpu_torch.ops.norm import layer_norm

KERNEL_SHAPE = (8, 32, 512)  # (S, hidden 4S, D): the published PIPs' mixer
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

launches = 0     # kernel calls so far
plain_calls = 0  # plain versions the mixer ran off the CPU so far
_fn = None


def token_mix_reference(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The token half of a mixer block: the LayerNorm (``ops.norm.layer_norm``,
    f32, eps 1e-5) rounded to x's dtype, the FeedForward across the S tokens
    in x's dtype (each product, bias and the GELU rounded to it, as the JAX
    reference's Dense layers do), then the residual. x: (P, S, D); returns
    (P, S, D) in x's dtype."""
    cd = x.dtype
    xa = layer_norm(x, ln_scale, ln_bias).to(cd)
    h = xa.transpose(1, 2) @ w1.to(cd)  # (P, D, hidden)
    h = F.gelu(h + b1.to(cd), approximate="none")
    o = (h @ w2.to(cd)).transpose(1, 2)  # (P, S, D)
    return x + (o + b2.to(cd)[None, :, None])


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2) -> None:
    if x.dim() != 3 or w1.dim() != 2:
        raise ValueError(f"x must be (P, S, D) and w1 (S, hidden); got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    _, S, D = x.shape
    H = w1.shape[1]
    want = {"ln_scale": (ln_scale, (D,)), "ln_bias": (ln_bias, (D,)), "w1": (w1, (S, H)),
            "b1": (b1, (H,)), "w2": (w2, (H, S)), "b2": (b2, (S,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("token_ff").pips_token_ff
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def takes_kernel(args) -> bool:
    """Whether the kernel serves ``token_mix_block(*args)``: a CUDA x with
    points at a compiled shape and dtype, with autograd not recording (the
    kernel has no backward yet)."""
    x, w1 = args[0], args[3]
    P, S, D = x.shape
    return (x.device.type == "cuda" and P > 0 and (S, w1.shape[1], D) == KERNEL_SHAPE
            and x.dtype in KERNEL_DTYPES
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in args)))


def token_mix_block(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The token half of a mixer block: x (P, S, D), the LayerNorm's scale
    and bias (D,), fc1's kernel (S, 4S) and bias (4S,), fc2's kernel (4S, S)
    and bias (S,), all float32 as the modules store them. Returns (P, S, D)
    in x's dtype: ``token_mix_reference``'s value. A CPU x runs that plain
    version (with its gradient where autograd records). A CUDA x launches
    the kernel, which takes a contiguous, 16-byte aligned x at the calls
    ``takes_kernel`` admits; anything else raises."""
    global launches
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    _check(*args)
    if not takes_kernel(args):
        if x.device.type == "cpu":
            return token_mix_reference(*args)
        recording = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        raise ValueError(
            f"token_mix_block's kernel is a forward at (S, hidden, D) = {KERNEL_SHAPE} in "
            f"{KERNEL_DTYPES} on cuda; got x {tuple(x.shape)} {x.dtype} on {x.device}, hidden "
            f"{w1.shape[1]}, autograd {'recording' if recording else 'off'}: call "
            f"token_mix_reference")
    if not all(t.is_contiguous() for t in args) or x.data_ptr() % 16:
        raise ValueError("token_mix_block's CUDA kernel needs contiguous inputs and a 16-byte "
                         "aligned x")
    P, S, D = x.shape
    y = torch.empty_like(x)
    dev = x.device
    err = _kernel()(*(t.data_ptr() for t in args + (y,)), P, S, w1.shape[1], D,
                    int(x.dtype == torch.bfloat16), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"token_ff kernel launch failed: CUDA error {err}")
    launches += 1
    return y
