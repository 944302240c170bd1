"""3x3, stride-1, SAME convolution of a 64-channel input, for Hopper.

Counterpart of ``pips_tpu/kernels/conv_pallas.py:conv3x3_same``: the conv
that ``Pips(fuse_conv3=True)`` routes the encoder's four 64->64 stage-1 convs
through. On a CUDA tensor it launches the hand-written kernel in
``pips_tpu_torch/csrc/conv3x3_fwd.cu`` (which replaces the TPU kernel
``_conv3x3_pallas_raw``; the source's header says what bounds it and how its
design answers that). ``conv3x3_reference`` is its plain PyTorch version.

x is (B, C, H, W) and w (O, C, 3, 3) as ``F.conv2d`` takes them, where JAX
takes NHWC and HWIO. On the card x must be ``torch.channels_last`` (NHWC in
memory), and y comes back so: that is the encoder's format, since
``Pips.encode`` permutes (B*S, H, W, 3) frames and cuDNN keeps it. The
kernel reads it in place; any other CUDA layout raises rather than pay a
hidden transpose. The gradient is JAX's custom VJP: dx is the same kernel
run on dy with the rotated, in/out-swapped weights and a zero bias (a second
launch); dW is the library's weight-grad conv, as JAX leaves it to XLA; db
sums dy in f32. dW and db come back in the
kernel weight's dtype, as JAX's ``_bwd`` casts them, and autograd casts them
to each parameter's own dtype: in a bf16 encoder the f32 conv weights and
biases receive bf16-rounded grads, the values JAX returns.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels import _build

KERNEL_C = 64  # the kernel holds up to 64 input and 64 output channels

launches = 0  # kernel launches so far (forward and dx); read (and reset) by chip_smoke.py
_fn = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the operands rounded to x's dtype, products summed in
    f32 with the f32 bias, one rounding to x's dtype. On CUDA an f32 conv is
    exact only with ``torch.backends.cudnn.allow_tf32 = False``."""
    return F.conv2d(x.float(), w.to(x.dtype).float(), b.float(), padding=1).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("conv3x3_fwd").pips_conv3x3_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w, b):
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (B, C, H, W) float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    C, O = x.shape[1], w.shape[0]
    if tuple(w.shape) != (O, C, 3, 3) or tuple(b.shape) != (O,):
        raise ValueError(f"w must be (O, {C}, 3, 3) and b (O,), got {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    if not (w.is_floating_point() and b.is_floating_point()):
        raise ValueError(f"w and b must be floating point, got {w.dtype} and {b.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"w on {w.device} and b on {b.device}, x on {x.device}")


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conv's value: the plain version on a CPU tensor, the kernel on CUDA.
    w is in x's dtype here, b in f32."""
    global launches
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same runs on cpu or cuda, not {x.device}")
    B, C, H, W = x.shape
    O = w.shape[0]
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the CUDA conv3x3 reads x in torch.channels_last memory format; "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    if not (0 < C <= KERNEL_C and C % 8 == 0 and 0 < O <= KERNEL_C and O % 8 == 0
            and B * H * W > 0):
        raise ValueError(f"the CUDA conv3x3 takes multiples of 8 up to {KERNEL_C} input and "
                         f"output channels; got C={C}, O={O}, {B}x{H}x{W}")
    w, b = w.contiguous(), b.contiguous()
    y = torch.empty(B, O, H, W, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if any(t.data_ptr() % 16 for t in (x, w, b, y)):
        raise ValueError("conv3x3_same's CUDA kernel needs 16-byte aligned tensors")
    err = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, C, H, W, O,
                    _DTYPE_CODE[x.dtype], x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return y


class _Conv3x3(torch.autograd.Function):
    """The custom VJP of ``pips_tpu/kernels/conv_pallas.py:conv3x3_same``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _forward(x, w.to(x.dtype), b.float())

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)  # keeps its format: channels_last, as the kernel reads it
        wk = w.to(x.dtype)
        # dx: the full correlation, i.e. the same conv of dy with rot180(w), in/out swapped
        dx = _forward(dy, wk.flip(2, 3).transpose(0, 1),
                      torch.zeros(x.shape[1], dtype=torch.float32, device=x.device))
        dw = torch.nn.grad.conv2d_weight(x, tuple(w.shape), dy, padding=1)
        db = dy.sum(dim=(0, 2, 3), dtype=torch.float32)
        return dx, dw.to(w.dtype), db.to(w.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3, stride-1, SAME conv. x (B, C, H, W) float32 or bfloat16; w
    (O, C, 3, 3) in any float dtype, cast to x's; b (O,), added in f32 before
    the one rounding. Returns (B, O, H, W) in x's dtype, with a gradient when
    any input requires one.

    On CUDA the kernel takes a channels_last x and multiples of 8 up to 64
    input and output channels (the encoder's stage-1 convs: C = O = 64);
    anything else raises.
    """
    _check(x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _Conv3x3.apply(x, w, b)
    return _forward(x, w.to(x.dtype), b.float())
