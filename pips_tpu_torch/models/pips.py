"""Pips: persistent-point tracking over S-frame windows
(counterpart of ``pips_tpu/models/pips.py``).

Encode the window, start each query point's trajectory at zero velocity,
run ``iters`` MLP-Mixer refinement updates over multi-scale correlation
patches, and read visibility logits off the final point features. Coords
are detached at each iteration start; eval locks frame 0 after every update.
This slice serves inference: ``corr_mode`` is ``onehot`` (serving) or
``full`` (reference formulation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.models.encoder import BasicEncoder
from pips_tpu_torch.models.mixer import Dense, DeltaBlock, LayerNorm, gelu
from pips_tpu_torch.ops.corr import build_fmap_pyramid, corr_pyramid, sample_corr_pyramid
from pips_tpu_torch.ops.samp import bilinear_sample2d

CORR_MODES = ("onehot", "full")


class PipsOutput(NamedTuple):
    coord_predictions: torch.Tensor   # (I, B, S, N, 2) pixel coords, one per iteration
    coord_predictions2: torch.Tensor  # (I+4, B, S, N, 2) padded sequence
    vis_e: torch.Tensor               # (B, S, N) visibility logits
    ffeat: torch.Tensor               # (B, N, C) frame-0 appearance feature


def resolve_device(device) -> torch.device:
    """The device to run on; raises for CUDA when no card is present rather
    than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a numpy seed: conv weights He-normal over
    fan-out, dense kernels LeCun-normal over fan-in, norm scales 1, biases 0."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":  # conv (O, I, kh, kw)
                std = np.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
                val = rng.standard_normal(tuple(p.shape)) * std
            elif leaf == "kernel":  # dense (in, out)
                val = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[0])
            elif leaf == "scale":
                val = np.ones(tuple(p.shape))
            elif leaf == "bias":
                val = np.zeros(tuple(p.shape))
            else:
                raise ValueError(f"no init rule for parameter {name}")
            p.copy_(torch.from_numpy(val.astype(np.float32)))
    return model


class Pips(nn.Module):
    """Parameters are float32; ``dtype`` (e.g. ``torch.bfloat16``) is the
    compute dtype. Coordinates, norms and corr accumulation stay f32."""

    def __init__(self, S: int = 8, stride: int = 8, latent_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 3, mixer_dim: int = 512,
                 mixer_depth: int = 12, dtype: Optional[torch.dtype] = None,
                 fuse_chanff: bool = False):
        super().__init__()
        self.S, self.stride, self.latent_dim = S, stride, latent_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride, dtype=dtype)
        self.delta_block = DeltaBlock(latent_dim, corr_levels, corr_radius, S, mixer_dim,
                                      mixer_depth, dtype=dtype, fuse_chanff=fuse_chanff)
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
              is_train: bool = False, corr_mode: str = "full") -> PipsOutput:
        """fmaps: (B, S, H8, W8, C); xys: (B, N, 2) query pixel coords in
        frame 0; coords_init: (B, S, N, 2) pixel coords; feat_init: (B, N, C)."""
        if corr_mode not in CORR_MODES:
            raise ValueError(f"corr_mode must be one of {CORR_MODES}, got {corr_mode!r}")
        B, S, H8, W8, C = fmaps.shape
        if S != self.S or iters < 1:
            raise ValueError(f"model takes S={self.S} frames and iters >= 1, got {S}, {iters}")
        N = xys.shape[1]
        r = self.corr_radius

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
        times = torch.linspace(0.0, float(S), S, device=fmaps.device).reshape(1, S, 1)
        times = times.expand(B * N, S, 1)

        preds = []
        for _ in range(iters):
            coords = coords.detach()
            if corr_mode == "onehot":
                corrs = corr_pyramid(pyramid, ffeats, out_dtype=fmaps.dtype)
                fcorrs = sample_corr_onehot(corrs, coords, r)
            else:
                fcorrs = sample_corr_pyramid(corr_pyramid(pyramid, ffeats), coords, r)

            # mixer layout: (B*N, S, .)
            fcorrs_ = fcorrs.transpose(1, 2).reshape(B * N, S, fcorrs.shape[-1])
            flows_ = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
            flows_ = torch.cat([flows_, times], dim=2)
            ffeats_ = ffeats.transpose(1, 2).reshape(B * N, S, C)

            delta_all_ = self.delta_block(ffeats_, fcorrs_, flows_)  # (B*N, S, C+2)
            delta_coords_ = delta_all_[:, :, :2]
            delta_feats_ = delta_all_[:, :, 2:].reshape(B * N * S, C)

            ffeats_flat = ffeats_.reshape(B * N * S, C)
            ffeats_flat = gelu(self.ffeat_updater(self.ffeat_norm(delta_feats_))) + ffeats_flat
            # features stay in the compute dtype for the next iteration's corr
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
                is_train: bool = False, corr_mode: str = "full") -> PipsOutput:
        """Full forward: encode + track."""
        return self.track(self.encode(rgbs), xys, coords_init=coords_init,
                          feat_init=feat_init, iters=iters, is_train=is_train,
                          corr_mode=corr_mode)


def make_pips(device="cuda", seed: int = 0, **config) -> Pips:
    """A ``Pips(**config)`` with parameters from ``init_params(seed)``, in eval
    mode on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return init_params(Pips(**config), seed).to(device).eval()
