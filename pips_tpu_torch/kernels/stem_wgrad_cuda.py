"""The weight gradient of the encoder's stem conv in its W-space-to-depth
form, for Hopper.

Counterpart of ``pips_tpu/kernels/stem_wgrad_pallas.py``. The stem's 7x7/2
conv of 3 channels, with its input W-space-to-depth packed (x2: 6 channels
at half the width), is a stride-(2, 1) VALID conv with 7x4 taps, 6 -> 64
channels. Its weight gradient is

    dk[o, c, ky, kx] = sum_{b, h, w'} x2[b, c, 2h + ky, w' + kx] * dy[b, o, h, w']

a sum over K = B * Ho * Wo pixels for each of 7*4*6*64 = 10,752 outputs. On a
CUDA tensor ``stem_wgrad`` launches the hand-written kernel in
``pips_tpu_torch/csrc/stem_wgrad.cu``, which replaces the TPU kernel
``_wgrad_kernel`` and reads x2 in place at row stride 2, so the row-tap
tensor x7 is never written to device memory (the source's header says what
bounds it); ``stem_wgrad_reference`` is its plain version.

``stem_wgrad`` returns None exactly where JAX's does (a row count that
``_pick_tile`` does not tile, or a width too narrow for the taps), and
``stem_conv_s2d``'s backward then takes the library's weight-grad conv,
where JAX takes XLA's. Its forward is the library conv, as JAX keeps XLA's,
and its input cotangent is zero by contract (x2 is the network's input).

Layouts are PyTorch's: x2 (B, 6, Hp, Wp), dy (B, 64, Ho, Wo), both
``torch.channels_last`` on the card (another CUDA layout raises); dk comes
back f32 as ``F.conv2d``'s weight, (64, 6, 7, 4). A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels import _build

KERNEL_TAPS = (7, 4)  # KY, KX the kernel takes
KERNEL_C, KERNEL_O = 6, 64

launches = 0  # stem_wgrad kernel calls so far; read (and reset) by chip_smoke.py
_fns = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pick_tile(Ho: int) -> int:
    for th in (24, 16, 32, 12, 8):
        if Ho % th == 0:
            return th
    return 0


def stem_wgrad_supported(Ho: int, Wo: int, Wp: int, KX: int = 4) -> bool:
    """Static tileability check callers use to choose the conv path."""
    return _pick_tile(Ho) != 0 and Wo + KX - 1 <= Wp


def stem_wgrad_reference(x2: torch.Tensor, dy: torch.Tensor, KY: int = 7,
                         KX: int = 4) -> torch.Tensor:
    """Plain version: per tap, an f32 product of the widened operands over
    every (b, h, w') pixel. Returns (O, C, KY, KX) f32."""
    Ho, Wo = dy.shape[2], dy.shape[3]
    dyf = dy.float()
    taps = [[torch.einsum("bchw,bohw->oc",
                          x2[:, :, ky:ky + 2 * Ho - 1:2, kx:kx + Wo].float(), dyf)
             for kx in range(KX)] for ky in range(KY)]
    return torch.stack([torch.stack(row, dim=-1) for row in taps], dim=-2)


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("stem_wgrad")
        fn = lib.pips_stem_wgrad
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks = lib.pips_stem_wgrad_blocks
        blocks.argtypes = [ctypes.c_int] * 4
        blocks.restype = ctypes.c_int
        _fns = fn, blocks
    return _fns


def stem_wgrad(x2: torch.Tensor, dy: torch.Tensor, KY: int = 7, KX: int = 4):
    """dk (O, C, KY, KX) f32 for the stride-(2, 1) VALID stem conv, or None
    where the shape does not tile (as JAX's). x2 (B, C, Hp, Wp) with
    Hp >= 2*(Ho-1) + KY; dy (B, O, Ho, Wo) in x2's dtype."""
    global launches
    B, C, Hp, Wp = x2.shape
    _, O, Ho, Wo = dy.shape
    if _pick_tile(Ho) == 0 or Wo + KX - 1 > Wp or Hp < 2 * (Ho - 1) + KY:
        return None
    if dy.shape[0] != B or dy.device != x2.device or dy.dtype != x2.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match x2 "
                         f"{tuple(x2.shape)} {x2.dtype} on {x2.device}")
    if x2.device.type == "cpu":
        return stem_wgrad_reference(x2, dy, KY, KX)
    if x2.device.type != "cuda":
        raise ValueError(f"stem_wgrad runs on cpu or cuda, not {x2.device}")
    if ((KY, KX) != KERNEL_TAPS or C != KERNEL_C or O != KERNEL_O
            or x2.dtype not in _DTYPE_CODE):
        raise ValueError(f"the CUDA stem_wgrad takes 7x4 taps, 6 -> 64 channels, float32 or "
                         f"bfloat16; got {KY}x{KX}, {C} -> {O}, {x2.dtype}")
    cl = torch.channels_last
    if not (x2.is_contiguous(memory_format=cl) and dy.is_contiguous(memory_format=cl)):
        raise ValueError("the CUDA stem_wgrad reads x2 and dy in torch.channels_last memory "
                         f"format; got strides {x2.stride()} and {dy.stride()}")
    fn, blocks = _kernel()
    nblocks = blocks(B, Ho, Wo, x2.device.index)
    if nblocks <= 0:
        raise RuntimeError(f"stem_wgrad: no launch configuration for B={B}, Ho={Ho}, Wo={Wo}")
    dk = torch.empty(O, C, KY, KX, dtype=torch.float32, device=x2.device)
    part = torch.empty(nblocks, dk.numel(), dtype=torch.float32, device=x2.device)  # scratch
    if any(t.data_ptr() % 16 for t in (x2, dy, dk, part)):
        raise ValueError("stem_wgrad's CUDA kernel needs 16-byte aligned tensors")
    err = fn(x2.data_ptr(), dy.data_ptr(), dk.data_ptr(), part.data_ptr(), nblocks, B, Hp, Wp,
             Ho, Wo, _DTYPE_CODE[x2.dtype], x2.device.index,
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"stem_wgrad kernel launch failed: CUDA error {err}")
    launches += 1
    return dk


class _StemConvS2d(torch.autograd.Function):
    """The custom VJP of ``stem_wgrad_pallas.py:stem_conv_s2d``."""

    @staticmethod
    def forward(ctx, x2, k2):
        ctx.save_for_backward(x2, k2)
        return F.conv2d(x2, k2, stride=(2, 1))

    @staticmethod
    def backward(ctx, dy):
        x2, k2 = ctx.saved_tensors
        KY, KX = k2.shape[2], k2.shape[3]
        if x2.is_cuda:
            dy = dy.contiguous(memory_format=torch.channels_last)  # the kernel's format
        dk = stem_wgrad(x2, dy, KY=KY, KX=KX)
        if dk is None:  # untileable shape: the library's weight grad, as JAX takes XLA's
            dk = torch.nn.grad.conv2d_weight(x2, tuple(k2.shape), dy, stride=(2, 1))
        return torch.zeros_like(x2), dk.to(k2.dtype)


def stem_conv_s2d(x2: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Stride-(2, 1) VALID conv of x2 (B, C, Hp, Wp) with k2 (O, C, KY, KX),
    both in one dtype, whose weight gradient is ``stem_wgrad``. The input
    cotangent is zero by contract: only valid where x2 is the network's
    input."""
    return _StemConvS2d.apply(x2, k2)
