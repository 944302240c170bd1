"""Residual CNN feature encoder (counterpart of ``pips_tpu/models/encoder.py``).

NCHW indexing inside, as ``F.conv2d`` takes it; in memory the tensors are
``torch.channels_last``, since ``Pips.encode`` permutes NHWC frames and the
convs keep that format. The JAX encoder's W-space-to-depth
paths (``full_s2d``, the packed-kernel convs, the row-tap stem) are
exact-math rewrites for the TPU's layout; here each is the plain convolution
it equals, so ``full_s2d`` is accepted and changes nothing. ``fuse_conv3``
routes the convs that JAX routes through its Pallas kernel (3x3, stride 1,
pad 1, 64 -> 64 channels, even W: the four stage-1 convs) through
``kernels.conv_cuda.conv3x3_same``, whose CUDA kernel runs them on the card;
every other conv stays ``F.conv2d``, as every other conv stays ``nn.Conv`` in
JAX.

  conv 7x7/2 -> IN -> relu
  stage1: 2x ResidualBlock(64,  stride 1)   @ 1/2
  stage2: 2x ResidualBlock(96,  stride 2)   @ 1/4
  stage3: 2x ResidualBlock(128, stride 2)   @ 1/8
  stage4: 2x ResidualBlock(128, stride 2)   @ 1/16
  resize all to 1/stride, concat -> conv3x3(2*out) -> IN -> relu -> conv1x1(out)
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pips_tpu_torch.kernels.conv_cuda import conv3x3_same
from pips_tpu_torch.ops.resize import resize_bilinear_align_corners


class _InstanceNorm(torch.autograd.Function):
    """The custom VJP of ``pips_tpu/models/encoder.py:instance_norm``: saves
    y (in x's dtype) and rsig, and returns
    dx = rsig * (dy - mean(dy) - y * mean(dy * y)) in dy's dtype."""

    @staticmethod
    def forward(ctx, x, eps):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        mean_sq = (xf * xf).mean(dim=(2, 3), keepdim=True)
        rsig = torch.rsqrt((mean_sq - mean * mean).clamp_min(0.0) + eps)
        y = ((xf - mean) * rsig).to(x.dtype)
        ctx.save_for_backward(y, rsig)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, rsig = ctx.saved_tensors
        n = y.shape[2] * y.shape[3]
        dyf, yf = dy.float(), y.float()
        m1 = dyf.sum(dim=(2, 3), keepdim=True) / n
        m2 = (dyf * yf).sum(dim=(2, 3), keepdim=True) / n
        return (rsig * (dyf - m1 - yf * m2)).to(dy.dtype), None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine instance norm over (H, W) of NCHW x; f32 statistics from
    E[x^2] - E[x]^2 (clamped at 0), result in x's dtype. Its gradient is the
    JAX package's hand-derived one (``_InstanceNorm``)."""
    return _InstanceNorm.apply(x, eps)


class Conv(nn.Module):
    """Conv2d with explicit zero padding; weight (O, I, k, k) f32, run in
    ``dtype`` (or x's dtype) like flax ``nn.Conv(dtype=...)``. Parameters
    start at zero: ``models.pips.init_params`` or a loaded state_dict fills them.

    ``fuse=True`` sends the shapes JAX's ``Conv(fuse=True)`` sends to its
    kernel (3x3, stride 1, pad 1, 64 -> 64 channels, even W) through
    ``conv3x3_same``, with the bias in f32 as JAX passes it; the parameters
    are the same in every mode."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, pad: int = 0,
                 dtype: torch.dtype | None = None, fuse: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.pad, self.dtype, self.fuse = stride, pad, dtype, fuse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if (self.fuse and self.weight.shape[2:] == (3, 3) and self.stride == 1 and self.pad == 1
                and x.shape[1] == 64 and self.weight.shape[0] == 64 and x.shape[3] % 2 == 0):
            return conv3x3_same(x.to(dt), self.weight.to(dt), self.bias)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=self.pad)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with instance norm + relu and a strided 1x1 shortcut;
    ``fuse_conv3`` is passed to both 3x3 convs, as in JAX."""

    def __init__(self, c_in: int, planes: int, stride: int = 1, dtype=None,
                 fuse_conv3: bool = False):
        super().__init__()
        self.conv1 = Conv(c_in, planes, 3, stride, 1, dtype, fuse=fuse_conv3)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype, fuse=fuse_conv3)
        self.downsample = Conv(c_in, planes, 1, stride, 0, dtype) if stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """(B, 3, H, W) -> (B, output_dim, H // stride, W // stride).

    ``remat=True`` recomputes the stem conv and each residual block in the
    backward (``torch.utils.checkpoint``), as JAX's per-block ``nn.remat``:
    only block inputs are kept for the backward, and a fused conv runs its
    kernel again there. ``fuse_conv3`` and ``full_s2d`` are the JAX fields
    (module docstring).
    """

    def __init__(self, output_dim: int = 128, stride: int = 8,
                 stage_dims: Sequence[int] = (64, 96, 128, 128), dtype=None,
                 remat: bool = False, fuse_conv3: bool = False, full_s2d: bool = True):
        super().__init__()
        self.stride, self.dtype, self.remat = stride, dtype, remat
        self.fuse_conv3, self.full_s2d = fuse_conv3, full_s2d
        self.conv1 = Conv(3, stage_dims[0], 7, 2, 3, dtype)
        c_in = stage_dims[0]
        self.stage_names = []
        for i, dim in enumerate(stage_dims):
            for j in range(2):
                name = f"layer{i + 1}_{j}"
                stride_ij = 2 if (i > 0 and j == 0) else 1
                self.add_module(name, ResidualBlock(c_in, dim, stride_ij, dtype, fuse_conv3))
                self.stage_names.append(name)
                c_in = dim
        self.conv2 = Conv(sum(stage_dims), output_dim * 2, 3, 1, 1, dtype)
        self.conv3 = Conv(output_dim * 2, output_dim, 1, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_hw = (x.shape[2] // self.stride, x.shape[3] // self.stride)
        if self.dtype is not None:
            x = x.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()

        def run(module, t):
            return checkpoint(module, t, use_reentrant=False) if remat else module(t)

        x = F.relu(instance_norm(run(self.conv1, x)))
        feats = []
        for k, name in enumerate(self.stage_names):
            x = run(getattr(self, name), x)
            if k % 2 == 1:
                feats.append(resize_bilinear_align_corners(x, out_hw))
        x = self.conv2(torch.cat(feats, dim=1))
        x = F.relu(instance_norm(x))
        return self.conv3(x)
