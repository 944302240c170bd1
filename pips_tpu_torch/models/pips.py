"""Pips: persistent-point tracking over S-frame windows
(counterpart of ``pips_tpu/models/pips.py``).

Encode the window, start each query point's trajectory at zero velocity,
run ``iters`` MLP-Mixer refinement updates over multi-scale correlation
patches, and read visibility logits off the final point features. Coords
are detached at each iteration start; eval locks frame 0 after every update.
Training (``compute_fcp``) samples through ``sample_corr_onehot`` whatever the
``corr_mode``, forms the score maps for the CE loss from one fused pyramid
map, and with ``ce_gt`` sums that loss inside the loop instead of stacking
the (B, S, I, N, H8, W8) maps. Serving picks with ``corr_mode`` how each
iteration samples the correlation pyramid (all four give the same values up
to rounding):

* ``onehot`` (serving default): full score maps in the compute dtype, then a
  gather of each point's patch (``kernels.corr_onehot``);
* ``full``: the reference formulation, f32 score maps and bilinear sampling;
* ``fused``: the gather form ``ops.corr.fused_corr_sample``, which never forms
  the score maps; scores stay f32;
* ``pallas`` (the JAX package's name for its fused kernel):
  ``kernels.corr_cuda.corr_sample``. On a CUDA tensor it launches the CUDA
  kernel ``csrc/corr_sample_fwd.cu``, once per iteration; on a CPU tensor it
  runs the plain version, ``fused``. Scores stay f32, so it matches
  ``fused``, not ``onehot`` (which rounds them to the compute dtype).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pips_tpu_torch.kernels.corr_cuda import corr_sample
from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.models.encoder import BasicEncoder
from pips_tpu_torch.models.mixer import Dense, DeltaBlock, LayerNorm, gelu
from pips_tpu_torch.models.losses import score_map_loss_single_iter
from pips_tpu_torch.ops.corr import (build_fmap_pyramid, corr_pyramid, fcp_from_fused,
                                     fused_corr_sample, fused_pyramid_fmap, sample_corr_pyramid)
from pips_tpu_torch.ops.samp import bilinear_sample2d
from pips_tpu_torch.utils.spans import span

CORR_MODES = ("onehot", "full", "fused", "pallas")


class PipsOutput(NamedTuple):
    coord_predictions: torch.Tensor   # (I, B, S, N, 2) pixel coords, one per iteration
    coord_predictions2: torch.Tensor  # (I+4, B, S, N, 2) padded sequence
    vis_e: torch.Tensor               # (B, S, N) visibility logits
    ffeat: torch.Tensor               # (B, N, C) frame-0 appearance feature
    fcps: Optional[torch.Tensor] = None     # (B, S, I, N, H8, W8) train-time score maps
    ce_loss: Optional[torch.Tensor] = None  # score-map CE from the loop, mean over I


def resolve_device(device) -> torch.device:
    """The device to run on; raises for CUDA when no card is present rather
    than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of a ``Pips`` or ``Pips2`` from a numpy seed: conv
    weights He-normal over fan-out, dense kernels LeCun-normal over fan-in
    (``Pips2``'s depthwise (3, 1, D) temporal kernels over their fan-in of
    3), norm scales 1, biases 0."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":  # conv (O, I, kh, kw)
                std = np.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
                val = rng.standard_normal(tuple(p.shape)) * std
            elif leaf == "kernel":  # dense (in, out), depthwise (taps, 1, out)
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
    compute dtype. Coordinates, norms and corr accumulation stay f32.

    ``remat_mixer``, ``remat_corr`` and ``remat_encoder`` recompute, in the
    backward, the DeltaBlock, each iteration's score volumes and each encoder
    block (``torch.utils.checkpoint``), as the JAX flags of the same names.
    ``fuse_conv3`` runs the encoder's four stage-1 3x3 convs through
    ``kernels.conv_cuda.conv3x3_same`` (on the card, ``csrc/conv3x3_fwd.cu``:
    4 launches per ``encode``, 4 more for dx in the backward); ``full_s2d``,
    a TPU layout choice, is accepted and computes the same plain convs."""

    def __init__(self, S: int = 8, stride: int = 8, latent_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 3, mixer_dim: int = 512,
                 mixer_depth: int = 12, dtype: Optional[torch.dtype] = None,
                 remat_mixer: bool = False, remat_corr: bool = False,
                 remat_encoder: bool = False, fuse_chanff: bool = False,
                 fuse_conv3: bool = False, full_s2d: bool = True):
        super().__init__()
        self.S, self.stride, self.latent_dim = S, stride, latent_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.remat_corr = remat_corr
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride, dtype=dtype,
                                 remat=remat_encoder, fuse_conv3=fuse_conv3,
                                 full_s2d=full_s2d)
        self.delta_block = DeltaBlock(latent_dim, corr_levels, corr_radius, S, mixer_dim,
                                      mixer_depth, dtype=dtype, fuse_chanff=fuse_chanff,
                                      remat=remat_mixer)
        self.ffeat_norm = LayerNorm(latent_dim)
        self.ffeat_updater = Dense(latent_dim, latent_dim)
        self.vis_predictor = Dense(latent_dim, 1)

    def encode(self, rgbs: torch.Tensor) -> torch.Tensor:
        """rgbs: (B, S, H, W, 3) in [0, 255] -> fmaps (B, S, H/stride, W/stride, C)."""
        with span("pips.encode"):
            B, S, H, W, _ = rgbs.shape
            x = 2.0 * (rgbs / 255.0) - 1.0
            f = self.fnet(x.reshape(B * S, H, W, 3).permute(0, 3, 1, 2))
            return f.permute(0, 2, 3, 1).reshape(B, S, f.shape[2], f.shape[3], self.latent_dim)

    def track(self, fmaps: torch.Tensor, xys: torch.Tensor,
              coords_init: Optional[torch.Tensor] = None,
              feat_init: Optional[torch.Tensor] = None, iters: int = 3,
              is_train: bool = False, compute_fcp: bool = False,
              use_fused_corr: bool = False, corr_mode: Optional[str] = None,
              ce_gt: Optional[tuple] = None) -> PipsOutput:
        """fmaps: (B, S, H8, W8, C); xys: (B, N, 2) query pixel coords in
        frame 0; coords_init: (B, S, N, 2) pixel coords; feat_init: (B, N, C).

        The arguments come in the JAX package's order. ``corr_mode`` picks the
        corr path (one of ``CORR_MODES``); left None it is ``"fused"`` when
        ``use_fused_corr`` and ``"full"`` otherwise, as in JAX.

        ``compute_fcp`` (training) returns the score maps as ``fcps`` or, with
        ``ce_gt = (trajs_g pixels (B, S, N, 2), vis_g, valids)``, their CE loss
        averaged over the iterations as ``ce_loss``; it ignores ``corr_mode``.
        """
        with span("pips.track"):
            corr_mode = corr_mode or ("fused" if use_fused_corr else "full")
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
            if corr_mode == "pallas":  # the kernel reads dense maps; copy once per window
                pyramid = [fm.contiguous() for fm in pyramid]
            if feat_init is None:
                ffeat = bilinear_sample2d(fmaps[:, 0], coords[:, 0, :, 0], coords[:, 0, :, 1])
            else:
                ffeat = feat_init
            ffeats = ffeat[:, None].expand(B, S, N, C)
            coords_bak = coords
            # the train-time score maps are one product against the fused map
            fm_fcp = fused_pyramid_fmap(pyramid, (H8, W8)) if compute_fcp else None

            def corr_chunk(ffeats_c, coords_c):
                # score volumes and fcp in the compute dtype; fcp feeds the CE loss
                corrs = corr_pyramid(pyramid, ffeats_c, out_dtype=fmaps.dtype)
                fcp = fcp_from_fused(fm_fcp, ffeats_c).to(fmaps.dtype)
                return fcp, sample_corr_onehot(corrs, coords_c, r)

            times = torch.linspace(0.0, float(S), S, device=fmaps.device).reshape(1, S, 1)
            times = times.expand(B * N, S, 1)

            preds, fcps, ce_acc = [], [], []
            for _ in range(iters):
                coords = coords.detach()
                with span("track.corr"):
                    if compute_fcp:
                        if self.remat_corr and torch.is_grad_enabled():
                            fcp, fcorrs = checkpoint(corr_chunk, ffeats, coords,
                                                     use_reentrant=False)
                        else:
                            fcp, fcorrs = corr_chunk(ffeats, coords)
                        if ce_gt is not None:
                            trajs_g, vis_g, valids = ce_gt
                            ce_acc.append(score_map_loss_single_iter(
                                fcp, trajs_g / float(self.stride), vis_g, valids))
                        else:
                            fcps.append(fcp)
                    elif corr_mode == "onehot":
                        corrs = corr_pyramid(pyramid, ffeats, out_dtype=fmaps.dtype)
                        fcorrs = sample_corr_onehot(corrs, coords, r)
                    elif corr_mode == "fused":
                        fcorrs = fused_corr_sample(pyramid, ffeats, coords, r)
                    elif corr_mode == "pallas":
                        fcorrs = corr_sample(pyramid, ffeats, coords, r)
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
                fcps=torch.stack(fcps, dim=2) if fcps else None,
                ce_loss=sum(ce_acc) / len(ce_acc) if ce_acc else None,
            )

    def forward(self, xys: torch.Tensor, rgbs: torch.Tensor,
                coords_init: Optional[torch.Tensor] = None,
                feat_init: Optional[torch.Tensor] = None, iters: int = 3,
                is_train: bool = False, compute_fcp: bool = False,
                use_fused_corr: bool = False, corr_mode: Optional[str] = None,
                ce_gt: Optional[tuple] = None) -> PipsOutput:
        """Full forward: encode + track, with ``track``'s arguments."""
        return self.track(self.encode(rgbs), xys, coords_init=coords_init,
                          feat_init=feat_init, iters=iters, is_train=is_train,
                          compute_fcp=compute_fcp, use_fused_corr=use_fused_corr,
                          corr_mode=corr_mode, ce_gt=ce_gt)


def make_pips(device="cuda", seed: int = 0, **config) -> Pips:
    """A ``Pips(**config)`` with parameters from ``init_params(seed)``, in eval
    mode on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return init_params(Pips(**config), seed).to(device).eval()
