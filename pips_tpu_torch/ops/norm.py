"""flax's ``nn.LayerNorm`` as one function: the math of ``models.mixer.LayerNorm``
and of the token half's plain version, ``kernels.token_cuda.token_mix_reference``."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics, var = E[x^2] - mu^2
    clamped at 0, applied as (x - mu) * (rsqrt(var + eps) * scale) + bias;
    the result is float32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (xf - mu) * (torch.rsqrt(var + eps) * scale) + bias
