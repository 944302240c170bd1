"""MLP-Mixer trajectory refiner (counterpart of ``pips_tpu/models/mixer.py``).

The DeltaBlock takes, per point, an (S, kitchen) input of [point features |
corr patches | sincos-embedded flow and time] and returns per-frame
(dxy, dfeat) through a depth-12 MLP-Mixer whose tokens are the S frames.

Dense kernels keep the JAX (in, out) layout, so the parameter bridge is a
plain copy and the fused channel block takes them as they are. Parameters
are float32; ``dtype`` is the compute dtype, as in the flax modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pips_tpu_torch.kernels.mixer_cuda import chan_ff_block
from pips_tpu_torch.kernels import token_cuda
from pips_tpu_torch.kernels.token_cuda import token_mix_block, token_mix_reference
from pips_tpu_torch.ops.embed import get_3d_embedding
from pips_tpu_torch.ops.norm import layer_norm
from pips_tpu_torch.utils.spans import span


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: f32 statistics with
    var = E[x^2] - mu^2 clamped at 0; the result is float32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (in, out), computed in ``dtype`` or, when
    that is None, in the promoted dtype of input and parameters."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        return x.to(cd) @ self.kernel.to(cd) + self.bias.to(cd)


def embed_parts(embed: Dense, x, dtype=None) -> torch.Tensor:
    """``embed`` applied to x (B, S, input_dim), or to a tuple of parts whose
    last dims sum to input_dim: a sum of per-part products with slices of the
    one kernel, so the concat is never built. Computed in ``dtype``, or the
    first part's dtype when that is None."""
    parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if sum(p.shape[-1] for p in parts) != embed.kernel.shape[0]:
        raise ValueError(f"inputs sum to {sum(p.shape[-1] for p in parts)} "
                         f"channels, the embedding takes {embed.kernel.shape[0]}")
    cd = dtype or parts[0].dtype
    wc = embed.kernel.to(cd)
    acc, off = None, 0
    for p in parts:
        k = p.shape[-1]
        term = p.to(cd) @ wc[off:off + k]
        off += k
        acc = term if acc is None else acc + term
    return acc + embed.bias.to(cd)


class TokenMixFF(nn.Module):
    """The parameters of the FeedForward across the token (S) axis, S ->
    S*expansion -> S. Its math, with the LayerNorm before it and the
    residual, is ``kernels.token_cuda.token_mix_reference``."""

    def __init__(self, tokens: int, expansion: int = 4):
        super().__init__()
        self.fc1 = Dense(tokens, tokens * expansion)
        self.fc2 = Dense(tokens * expansion, tokens)


class ChannelMixFF(nn.Module):
    """FeedForward across channels: D -> D*expansion -> D."""

    def __init__(self, dim: int, expansion: int = 4, dtype=None):
        super().__init__()
        self.fc1 = Dense(dim, dim * expansion, dtype)
        self.fc2 = Dense(dim * expansion, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class MLPMixer(nn.Module):
    """(B, S, input_dim) -> (B, output_dim), mean-pooled over S before the head.

    Each token half (LN -> the token FF across S -> residual) goes through
    ``kernels.token_cuda.token_mix_block``, ``csrc/token_ff.cu``'s kernel on
    the card: a forward at the published shape. Where it cannot serve a
    CUDA x, while autograd records (training, remat's recompute) and at
    other shapes, the mixer calls the plain version,
    ``token_mix_reference``, by name.
    ``fuse_chanff=True`` runs each channel block (LN -> fc1 -> GELU -> fc2 ->
    residual) through ``kernels.mixer_cuda.chan_ff_block``: on the card the
    tiled CUDA kernels of ``csrc/chanff_fwd.cu`` (three launches a forward)
    and ``csrc/chanff_bwd.cu`` (five a backward), on the CPU their plain
    versions.
    Parameters are the same either way.
    """

    def __init__(self, S: int, input_dim: int, dim: int, output_dim: int, depth: int,
                 expansion: int = 4, dtype=None, fuse_chanff: bool = False):
        super().__init__()
        self.depth = depth
        self.dtype, self.fuse_chanff = dtype, fuse_chanff
        self.embed = Dense(input_dim, dim)
        for d in range(depth):
            self.add_module(f"block{d}_token_norm", LayerNorm(dim))
            self.add_module(f"block{d}_token", TokenMixFF(S, expansion))
            self.add_module(f"block{d}_chan_norm", LayerNorm(dim))
            self.add_module(f"block{d}_chan", ChannelMixFF(dim, expansion, dtype))
        self.final_norm = LayerNorm(dim)
        self.head = Dense(dim, output_dim, dtype)

    def forward(self, x) -> torch.Tensor:
        # x: (B, S, input_dim), or a tuple of parts (``embed_parts``)
        x = embed_parts(self.embed, x, self.dtype)
        for d in range(self.depth):
            with span("mixer.token"):
                token = getattr(self, f"block{d}_token")
                norm = getattr(self, f"block{d}_token_norm")
                args = (x, norm.scale, norm.bias, token.fc1.kernel, token.fc1.bias,
                        token.fc2.kernel, token.fc2.bias)
                if x.device.type != "cpu" and not token_cuda.takes_kernel(args):
                    token_cuda.plain_calls += 1  # the card's plain token halves, counted
                    x = token_mix_reference(*args)
                else:
                    x = token_mix_block(*args)
            norm, chan = getattr(self, f"block{d}_chan_norm"), getattr(self, f"block{d}_chan")
            if self.fuse_chanff:
                B, S, D = x.shape
                # the f32 kernels go in as they are: the block casts them, so
                # their grads stay f32 (a cast here would round them to x's dtype)
                x = chan_ff_block(x.reshape(B * S, D), norm.scale, norm.bias, chan.fc1.kernel,
                                  chan.fc1.bias, chan.fc2.kernel, chan.fc2.bias).reshape(B, S, D)
            else:
                x = x + chan(norm(x).to(x.dtype))
        x = self.final_norm(x).mean(dim=1)
        return self.head(x)


class DeltaBlock(nn.Module):
    """Per-point update head: (ffeat, corr, flow) -> (B*, S, latent+2) deltas.

    kitchen = corr_levels*(2r+1)^2 + latent + 64*3 + 3 (519 at the defaults).
    ``remat=True`` recomputes the block's activations in the backward
    (``torch.utils.checkpoint``), as JAX's ``nn.remat(DeltaBlock)``.
    """

    def __init__(self, latent_dim: int = 128, corr_levels: int = 4, corr_radius: int = 3,
                 S: int = 8, mixer_dim: int = 512, mixer_depth: int = 12, dtype=None,
                 fuse_chanff: bool = False, remat: bool = False):
        super().__init__()
        self.S, self.latent_dim, self.remat = S, latent_dim, remat
        kitchen = corr_levels * (2 * corr_radius + 1) ** 2 + latent_dim + 64 * 3 + 3
        self.to_delta = MLPMixer(S, kitchen, mixer_dim, S * (latent_dim + 2), mixer_depth,
                                 dtype=dtype, fuse_chanff=fuse_chanff)

    def forward(self, fhid: torch.Tensor, fcorr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """fhid (B*, S, latent); fcorr (B*, S, L*(2r+1)^2); flow (B*, S, 3) = [dx, dy, t]."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, fhid, fcorr, flow, use_reentrant=False)
        return self._forward(fhid, fcorr, flow)

    def _forward(self, fhid, fcorr, flow):
        Bn = flow.shape[0]
        flow_sincos = get_3d_embedding(flow, 64, cat_coords=True)
        delta = self.to_delta((fhid, fcorr, flow_sincos))
        return delta.reshape(Bn, self.S, self.latent_dim + 2)
