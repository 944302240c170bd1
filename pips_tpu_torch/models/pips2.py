"""Pips2: the PIPs++ family, an S-agnostic point tracker
(counterpart of ``pips_tpu/models/pips2.py``).

The refiner has no weight whose shape depends on the window length S: depthwise
temporal convolutions take the place of the mixer's token mixing, and a
per-frame head the place of its flattened one, so one set of weights tracks
windows of any length. The rest is ``Pips``': the shared ``BasicEncoder``, the
corr paths, coords detached at each iteration start, the query frame locked
in eval.

Each ``TemporalBlock`` is LN -> depthwise k=3 conv over S (residual), then
LN -> channel FF (residual); ``fuse_chanff=True`` runs the second through
``kernels.mixer_cuda.chan_ff_block``, on the card the tiled CUDA kernels of
``csrc/chanff_fwd.cu`` and ``csrc/chanff_bwd.cu`` at the refiner's width D
(256 by default; they take 256 and 512). The temporal conv is no Pallas
kernel in JAX either (``nn.Conv``), so it stays plain PyTorch.

``corr_mode`` as in JAX: ``fused`` (gather form), ``onehot`` (score maps in
the compute dtype, then the one-hot gather); anything else, ``pallas``
included, computes ``full``. PIPs++ trains without the score-map CE term:
``compute_fcp`` and ``ce_gt`` are taken for the train step's sake and ignored,
and ``fcps`` and ``ce_loss`` come back None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.kernels.mixer_cuda import chan_ff_block
from pips_tpu_torch.models.encoder import BasicEncoder
from pips_tpu_torch.models.mixer import ChannelMixFF, Dense, LayerNorm, embed_parts, gelu
from pips_tpu_torch.models.pips import PipsOutput
from pips_tpu_torch.ops.corr import (build_fmap_pyramid, corr_pyramid, fused_corr_sample,
                                     sample_corr_pyramid)
from pips_tpu_torch.ops.embed import get_3d_embedding
from pips_tpu_torch.ops.samp import bilinear_sample2d


class TemporalConv(nn.Module):
    """flax ``nn.Conv(dim, (3,), padding="SAME", feature_group_count=dim)`` over
    the S axis of (R, S, dim): each channel its own 3 taps, zero frames past
    both ends. ``kernel`` keeps flax's (3, 1, dim) layout, so the parameter
    bridge copies it. Taps are summed in f32 and rounded once to the compute
    dtype, then the bias is added in it, as the flax module does."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 1, dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        k = self.kernel.to(cd).float()[:, 0]  # (3, dim)
        S = x.shape[1]
        xp = F.pad(x.to(cd).float(), (0, 0, 1, 1))
        y = xp[:, :S] * k[0] + xp[:, 1:S + 1] * k[1] + xp[:, 2:] * k[2]
        return y.to(cd) + self.bias.to(cd)


class TemporalBlock(nn.Module):
    """(R, S, dim) -> (R, S, dim); weights independent of S."""

    def __init__(self, dim: int, expansion: int = 4, dtype=None, fuse_chanff: bool = False):
        super().__init__()
        self.fuse_chanff = fuse_chanff
        self.tnorm = LayerNorm(dim)
        self.tconv = TemporalConv(dim, dtype)
        self.cnorm = LayerNorm(dim)
        self.cff = ChannelMixFF(dim, expansion, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.tconv(self.tnorm(x).to(x.dtype))
        if not self.fuse_chanff:
            return x + self.cff(self.cnorm(x).to(x.dtype))
        R, S, D = x.shape
        # the f32 kernels go in as they are (MLPMixer's rule: their grads stay f32)
        return chan_ff_block(x.reshape(R * S, D), self.cnorm.scale, self.cnorm.bias,
                             self.cff.fc1.kernel, self.cff.fc1.bias, self.cff.fc2.kernel,
                             self.cff.fc2.bias).reshape(R, S, D)


class TemporalRefiner(nn.Module):
    """(ffeats, fcorrs, flow_sincos), each (R, S, d_i) -> per-frame
    (dxy, dfeat) (R, S, latent + 2): the split embedding, ``depth``
    TemporalBlocks, a final LayerNorm and the per-frame head."""

    def __init__(self, input_dim: int, latent_dim: int = 128, dim: int = 256, depth: int = 6,
                 expansion: int = 4, dtype=None, fuse_chanff: bool = False):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.embed = Dense(input_dim, dim)
        for d in range(depth):
            self.add_module(f"block{d}", TemporalBlock(dim, expansion, dtype, fuse_chanff))
        self.final_norm = LayerNorm(dim)
        self.head = Dense(dim, latent_dim + 2, dtype)

    def forward(self, parts) -> torch.Tensor:
        x = embed_parts(self.embed, parts, self.dtype)
        for d in range(self.depth):
            x = getattr(self, f"block{d}")(x)
        return self.head(self.final_norm(x).to(x.dtype))


class Pips2(nn.Module):
    """S-agnostic PIPs++ tracker with ``Pips``' encode/track split and calling
    convention. Parameters are float32; ``dtype`` is the compute dtype."""

    def __init__(self, stride: int = 8, latent_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 3, refiner_dim: int = 256, refiner_depth: int = 6,
                 dtype: Optional[torch.dtype] = None, fuse_chanff: bool = False):
        super().__init__()
        self.stride, self.latent_dim = stride, latent_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride, dtype=dtype)
        input_dim = latent_dim + corr_levels * (2 * corr_radius + 1) ** 2 + 64 * 3 + 3
        self.refiner = TemporalRefiner(input_dim, latent_dim, refiner_dim, refiner_depth,
                                       dtype=dtype, fuse_chanff=fuse_chanff)
        self.ffeat_norm = LayerNorm(latent_dim)
        self.ffeat_updater = Dense(latent_dim, latent_dim)
        self.vis_predictor = Dense(latent_dim, 1)

    def encode(self, rgbs: torch.Tensor) -> torch.Tensor:
        """rgbs: (B, S, H, W, 3) in [0, 255] -> fmaps (B, S, H/stride, W/stride, C)."""
        B, S, H, W, _ = rgbs.shape
        x = 2.0 * (rgbs / 255.0) - 1.0
        f = self.fnet(x.reshape(B * S, H, W, 3).permute(0, 3, 1, 2))
        return f.permute(0, 2, 3, 1).reshape(B, S, f.shape[2], f.shape[3], self.latent_dim)

    def track(self, fmaps: torch.Tensor, xys: torch.Tensor,
              coords_init: Optional[torch.Tensor] = None,
              feat_init: Optional[torch.Tensor] = None, iters: int = 3,
              is_train: bool = False, use_fused_corr: bool = False,
              corr_mode: Optional[str] = None) -> PipsOutput:
        """fmaps: (B, S, H8, W8, C) for any S; xys: (B, N, 2) query pixel
        coords in frame 0; coords_init: (B, S, N, 2) pixel coords; feat_init:
        (B, N, C). The arguments come in the JAX package's order."""
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        B, S, H8, W8, C = fmaps.shape
        N = xys.shape[1]
        r = self.corr_radius
        mode = corr_mode or ("fused" if use_fused_corr else "full")
        if coords_init is None:
            coords = (xys / float(self.stride))[:, None].expand(B, S, N, 2)
        else:
            coords = coords_init / float(self.stride)
        pyramid = build_fmap_pyramid(fmaps, self.corr_levels)
        if feat_init is None:
            ffeat = bilinear_sample2d(fmaps[:, 0], coords[:, 0, :, 0], coords[:, 0, :, 1])
        else:
            ffeat = feat_init
        ffeats = ffeat[:, None].expand(B, S, N, C)
        coords_bak = coords
        # a time channel in [0, 1] whatever S (the mixer's 0..S would change scale with S)
        times = torch.linspace(0.0, 1.0, S, device=fmaps.device).reshape(1, S, 1)
        times = times.expand(B * N, S, 1)

        preds = []
        for _ in range(iters):
            coords = coords.detach()
            if mode == "fused":
                fcorrs = fused_corr_sample(pyramid, ffeats, coords, r)
            elif mode == "onehot":
                fcorrs = sample_corr_onehot(corr_pyramid(pyramid, ffeats, out_dtype=fmaps.dtype),
                                            coords, r)
            else:
                fcorrs = sample_corr_pyramid(corr_pyramid(pyramid, ffeats), coords, r)

            fcorrs_ = fcorrs.transpose(1, 2).reshape(B * N, S, fcorrs.shape[-1])
            flows_ = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
            flow_sincos = get_3d_embedding(torch.cat([flows_, times], dim=2), 64,
                                           cat_coords=True)
            ffeats_ = ffeats.transpose(1, 2).reshape(B * N, S, C)

            delta = self.refiner((ffeats_, fcorrs_, flow_sincos))  # (B*N, S, C+2)
            delta_coords_ = delta[:, :, :2]
            delta_feats_ = delta[:, :, 2:].reshape(B * N * S, C)
            ffeats_flat = ffeats_.reshape(B * N * S, C)
            ffeats_flat = gelu(self.ffeat_updater(self.ffeat_norm(delta_feats_))) + ffeats_flat
            ffeats = ffeats_flat.to(fmaps.dtype).reshape(B, N, S, C).transpose(1, 2)
            coords = coords + delta_coords_.float().reshape(B, N, S, 2).transpose(1, 2)
            if not is_train:  # lock the query frame
                coords = torch.cat([coords_bak[:, :1], coords[:, 1:]], dim=1)
            preds.append(coords * self.stride)

        vis_e = self.vis_predictor(ffeats.reshape(B * S * N, C).float()).reshape(B, S, N)
        first = coords_bak * self.stride
        return PipsOutput(
            coord_predictions=torch.stack(preds),
            coord_predictions2=torch.stack([first, first, *preds, preds[-1], preds[-1]]),
            vis_e=vis_e,
            ffeat=ffeat,
        )

    def forward(self, xys: torch.Tensor, rgbs: torch.Tensor,
                coords_init: Optional[torch.Tensor] = None,
                feat_init: Optional[torch.Tensor] = None, iters: int = 3,
                is_train: bool = False, compute_fcp: bool = False,
                use_fused_corr: bool = False, corr_mode: Optional[str] = None,
                ce_gt: Optional[tuple] = None) -> PipsOutput:
        """Encode + track with ``Pips``' arguments; ``compute_fcp`` and
        ``ce_gt`` are ignored (no score-map CE), so ``fcps`` and ``ce_loss``
        are None."""
        del compute_fcp, ce_gt
        return self.track(self.encode(rgbs), xys, coords_init=coords_init,
                          feat_init=feat_init, iters=iters, is_train=is_train,
                          use_fused_corr=use_fused_corr, corr_mode=corr_mode)
