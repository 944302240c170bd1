"""The fused stage-1 residual block, for Hopper.

Counterpart of ``pips_tpu/kernels/block_pallas.py``: ``res_block64`` is the
whole 64-channel stride-1 residual block

    relu(x + relu(IN(conv2(relu(IN(conv1(x)))))))

behind one autograd Function, as JAX puts it behind one custom VJP. Its
building block is ``conv_pass``, the counterpart of ``_conv_pass``: a 3x3
SAME 64->64 conv with an f32 bias whose epilogue also returns the per-image,
per-channel f32 (sum, sumsq) of the unrounded output (the instance norm's
statistics), and whose optional prologue applies a per-image affine and relu
to the input's in-image pixels (the first norm, folded into the second conv).
On a CUDA tensor ``conv_pass`` launches the hand-written kernel in
``pips_tpu_torch/csrc/conv3x3_stats.cu``, which replaces the TPU kernel
``_conv3x3_stats_kernel`` (the source's header says what bounds it and how
its design answers that), as ``pass_plan`` lays it out.
``conv_pass_reference`` is its plain version.

The forward is two passes; the backward two more (the dgrad convs: the same
kernel, prologue off, zero bias, rotated in/out-swapped weights). What JAX
leaves to XLA outside its kernel stays PyTorch ops here: the statistics'
sum over tiles, the residual tail, the instance-norm backward on the raw
rounded conv outputs with the saved statistics, the relu masks, db (an f32
sum) and the weight grads (the library's weight-grad conv in x's dtype,
which is what JAX's s2d wgrad and its unpacking amount to).

Layouts are PyTorch's: x (B, 64, H, W), w (O, C, 3, 3). JAX's W-space-to-depth
packing is TPU plumbing; here the statistics are plain per-(image, channel)
sums over H*W. On the card x must be ``torch.channels_last``, as the
encoder holds it; another CUDA layout raises. ``res_block64`` keeps JAX's
contract of an even W. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels import _build, conv_cuda, mixer_cuda

KERNEL_C = 64  # the kernel takes exactly 64 input and 64 output channels
EPS = 1e-5

launches = 0  # conv_pass kernel launches so far; read (and reset) by chip_smoke.py
_fn = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' output tiles (rows, columns), each writing one row of partial
# statistics: bf16 4 x 30, f32 8 x 32 (the f32 conv's tiles,
# csrc/conv3x3_f32_tiles.cuh); the CUDA entry refuses any other count
_TILES = {torch.bfloat16: (4, 30), torch.float32: conv_cuda.F32_TILE}


def stats_tiles(H: int, W: int, dtype: torch.dtype) -> int:
    """T, the rows of partial statistics per image that the CUDA kernel writes
    for an H x W input of ``dtype`` (its output (B, 2, 64, T) is summed over
    T by the wrapper)."""
    th, tw = _TILES[dtype]
    return -(-H // th) * -(-W // tw)


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """The one launch of a conv pass: ``T`` tiles an image, each tile's 64
    outputs in ``groups`` groups of ``tile_outputs``, ``grid`` blocks (f32:
    one a (tile, group), block i taking tile i // groups of the images' B * T
    and group i % groups; bf16: persistent blocks, one an SM, walking the
    tiles)."""
    T: int
    tile_outputs: int
    groups: int
    grid: int


def pass_plan(B: int, H: int, W: int, dtype: torch.dtype,
              sms: int = mixer_cuda.SMS) -> PassPlan:
    """The launch of ``conv_pass`` on x (B, 64, H, W) in ``dtype`` on a card
    of ``sms`` SMs: f32 splits the 64 outputs into groups across blocks where
    the tiles alone number fewer than ``sms``, as ``conv_cuda.launch_plan``
    does for the f32 conv."""
    if not (B > 0 and H > 0 and W > 0 and dtype in _DTYPE_CODE):
        raise ValueError(f"no conv_pass kernel takes {B}x64x{H}x{W} {dtype}")
    T = stats_tiles(H, W, dtype)
    if dtype == torch.float32:
        outputs = conv_cuda.f32_outputs(B * T, KERNEL_C, sms)
        groups = KERNEL_C // outputs
        return PassPlan(T, outputs, groups, B * T * groups)
    return PassPlan(T, KERNEL_C, 1, min(B * T, sms))


def conv_pass_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, aff: torch.Tensor,
                        prologue: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version. With ``prologue``, x becomes relu(x * aff[:, 0] +
    aff[:, 1]) in f32 (a multiply, then an add), rounded to x's dtype; the
    conv's zero padding is added after, so the border stays zero. Then the
    conv of the widened operands in f32 with the f32 bias: its per-image,
    per-channel (sum, sumsq), summed in f64 and rounded to f32, are the stats
    (B, 2, O), and y is it rounded once to x's dtype. On CUDA an f32 conv is
    exact only with ``torch.backends.cudnn.allow_tf32 = False``."""
    xf = x.float()
    if prologue:
        scale, shift = aff[:, 0, :, None, None].float(), aff[:, 1, :, None, None].float()
        xf = (xf * scale + shift).clamp_min(0.0).to(x.dtype).float()
    acc = F.conv2d(xf, w.to(x.dtype).float(), b.float(), padding=1)
    a64 = acc.double()  # the sums in f64, rounded once: no summation order to match
    stats = torch.stack([a64.sum(dim=(2, 3)), (a64 * a64).sum(dim=(2, 3))], dim=1).float()
    return acc.to(x.dtype), stats


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("conv3x3_stats").pips_conv3x3_stats
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv_pass(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, aff: torch.Tensor,
              prologue: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One conv pass: ``(y, stats)`` as ``conv_pass_reference`` defines them.
    x (B, 64, H, W) float32 or bfloat16; w (64, 64, 3, 3), cast to x's dtype;
    b (64,) and aff (B, 2, 64) [scale; shift], both used in f32 (aff only
    with ``prologue``). The plain version on a CPU tensor, the kernel on a
    CUDA one (channels_last x only)."""
    global launches
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE or x.shape[1] != KERNEL_C:
        raise ValueError(f"x must be (B, 64, H, W) float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    B, C, H, W = x.shape
    if (tuple(w.shape) != (C, C, 3, 3) or tuple(b.shape) != (C,)
            or tuple(aff.shape) != (B, 2, C)):
        raise ValueError(f"w must be (64, 64, 3, 3), b (64,) and aff ({B}, 2, 64); got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}, {tuple(aff.shape)}")
    if any(t.device != x.device for t in (w, b, aff)):
        raise ValueError(f"w, b and aff must lie on x's device {x.device}")
    if x.device.type == "cpu":
        return conv_pass_reference(x, w, b, aff, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pass runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the CUDA conv pass reads x in torch.channels_last memory format; "
                         f"got strides {x.stride()} for shape {tuple(x.shape)}")
    if B * H * W == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    plan = pass_plan(B, H, W, x.dtype, sms=mixer_cuda._device_sms(x.device))
    T = plan.T
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    aff = aff.float().contiguous()
    y = torch.empty(B, C, H, W, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    part = torch.empty(B, 2, C, T, dtype=torch.float32, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, w, b, aff, y, part)):
        raise ValueError("conv_pass's CUDA kernel needs 16-byte aligned tensors")
    err = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), aff.data_ptr(), y.data_ptr(),
                    part.data_ptr(), B, H, W, T, int(prologue), _DTYPE_CODE[x.dtype],
                    plan.tile_outputs, plan.grid, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv3x3_stats kernel launch failed: CUDA error {err}")
    launches += 1
    return y, part.sum(dim=-1)  # the tiles' partials summed outside the kernel, as JAX does


def _mean_rsig(st: torch.Tensor, n: int, eps: float = EPS):
    """st (B, 2, C) [sum, sumsq] over n pixels -> (mean, rsig), each
    (B, C, 1, 1) f32, with var = max(E[y^2] - E[y]^2, 0)."""
    mean = st[:, 0] / n
    var = (st[:, 1] / n - mean * mean).clamp_min(0.0)
    return mean[:, :, None, None], torch.rsqrt(var + eps)[:, :, None, None]


def _in_bwd(dyh: torch.Tensor, y_raw: torch.Tensor, mean: torch.Tensor,
            rsig: torch.Tensor) -> torch.Tensor:
    """Instance-norm backward on the raw rounded conv output and the saved
    statistics: given d(normed), d(raw) in dyh's dtype."""
    yf = (y_raw.float() - mean) * rsig
    dyf = dyh.float()
    m1 = dyf.mean(dim=(2, 3), keepdim=True)
    m2 = (dyf * yf).mean(dim=(2, 3), keepdim=True)
    return (rsig * (dyf - m1 - yf * m2)).to(dyh.dtype)


def _rot(w: torch.Tensor, dtype) -> torch.Tensor:
    """dgrad weights: rot180(w) with inputs and outputs swapped."""
    return w.to(dtype).flip(2, 3).transpose(0, 1)


class _ResBlock64(torch.autograd.Function):
    """The custom VJP of ``block_pallas.py:res_block64`` (``_rb_fwd`` and
    ``_rb_bwd``), with the conv pass given as an argument: ``conv_pass`` for
    ``res_block64``, ``conv_pass_reference`` for ``res_block64_reference``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, pass_fn):
        B, C, H, W = x.shape
        dt = x.dtype
        aff0 = torch.zeros(B, 2, C, dtype=torch.float32, device=x.device)
        y1, st1 = pass_fn(x, w1.to(dt), b1.float(), aff0, False)
        mean1, rsig1 = _mean_rsig(st1, H * W)
        aff1 = torch.stack([rsig1[:, :, 0, 0], -mean1[:, :, 0, 0] * rsig1[:, :, 0, 0]], dim=1)
        y2, st2 = pass_fn(y1, w2.to(dt), b2.float(), aff1, True)
        mean2, rsig2 = _mean_rsig(st2, H * W)
        r = ((y2.float() - mean2) * rsig2).clamp_min(0.0)
        out = (x.float() + r).clamp_min(0.0).to(dt)
        ctx.save_for_backward(x, y1, y2, mean1, rsig1, mean2, rsig2, w1, w2)
        ctx.pass_fn, ctx.b_dtypes = pass_fn, (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, y1, y2, mean1, rsig1, mean2, rsig2, w1, w2 = ctx.saved_tensors
        pass_fn = ctx.pass_fn
        B, C, H, W = x.shape
        dt = x.dtype
        aff0 = torch.zeros(B, 2, C, dtype=torch.float32, device=x.device)
        zb = torch.zeros(C, dtype=torch.float32, device=x.device)
        if x.is_cuda:  # the dgrad passes read their input as the forward's: channels_last
            dout = dout.contiguous(memory_format=torch.channels_last)

        # tail: out = relu(x + r), r = relu((y2 - mean2) * rsig2)
        yh2 = ((y2.float() - mean2) * rsig2).clamp_min(0.0)
        e = dout.float() * (x.float() + yh2 > 0)
        dy2 = _in_bwd((e * (yh2 > 0)).to(dt), y2, mean2, rsig2)

        # conv2: dgrad through the pass, wgrad by the library on its recomputed input
        yh1 = ((y1.float() - mean1) * rsig1).clamp_min(0.0).to(dt)
        dyh1, _ = pass_fn(dy2, _rot(w2, dt), zb, aff0, False)
        dw2 = torch.nn.grad.conv2d_weight(yh1, tuple(w2.shape), dy2, padding=1)
        db2 = dy2.sum(dim=(0, 2, 3), dtype=torch.float32)

        dy1 = _in_bwd((dyh1.float() * (yh1 > 0)).to(dt), y1, mean1, rsig1)
        dx, _ = pass_fn(dy1, _rot(w1, dt), zb, aff0, False)
        dw1 = torch.nn.grad.conv2d_weight(x, tuple(w1.shape), dy1, padding=1)
        db1 = dy1.sum(dim=(0, 2, 3), dtype=torch.float32)

        dx = (dx.float() + e).to(dt)
        b1_dt, b2_dt = ctx.b_dtypes
        return dx, dw1.to(w1.dtype), db1.to(b1_dt), dw2.to(w2.dtype), db2.to(b2_dt), None


def _check_block(x, w1, b1, w2, b2):
    if x.dim() != 4 or x.shape[1] != KERNEL_C or x.shape[3] % 2:
        raise ValueError(f"x must be (B, 64, H, W) with an even W, got {tuple(x.shape)}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (KERNEL_C, KERNEL_C, 3, 3):
            raise ValueError(f"{name} must be (64, 64, 3, 3), got {tuple(w.shape)}")
    for name, b in (("b1", b1), ("b2", b2)):
        if tuple(b.shape) != (KERNEL_C,):
            raise ValueError(f"{name} must be (64,), got {tuple(b.shape)}")


def res_block64(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The fused stage-1 residual block: x (B, 64, H, W) float32 or
    bfloat16 (B is the frame batch: the norm is per image), even W; w1, w2
    (64, 64, 3, 3) and b1, b2 (64,) in any float dtype (the weights are cast
    to x's, the biases used in f32). Returns (B, 64, H, W) in x's dtype, with
    the hand-written gradient. Two kernel launches forward, two backward."""
    _check_block(x, w1, b1, w2, b2)
    return _ResBlock64.apply(x, w1, b1, w2, b2, conv_pass)


def res_block64_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``res_block64`` with every conv pass the plain version: the same
    forward and the same hand-written backward, no kernel."""
    _check_block(x, w1, b1, w2, b2)
    return _ResBlock64.apply(x, w1, b1, w2, b2, conv_pass_reference)
