"""Training losses (counterpart of ``pips_tpu/models/losses.py``).

Fixed-shape and mask-based: the one-hot score-map targets are broadcast
comparisons, so nothing depends on the data's shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pips_tpu_torch.ops.reduce import EPS, mask_count, reduce_masked_mean


def balanced_ce_loss(pred: torch.Tensor, gt: torch.Tensor, valid=None):
    """Positive/negative-balanced sigmoid BCE on logits. gt > 0.95 are
    positives, gt < 0.05 negatives; each side is a masked mean and the two
    are summed. Returns (balanced loss, elementwise loss)."""
    if valid is None:
        valid = torch.ones_like(gt)
    pos = (gt > 0.95).float()
    neg = (gt < 0.05).float()
    a = -(pos * 2.0 - 1.0) * pred
    b = a.clamp_min(0.0)
    loss = b + torch.log(torch.exp(-b) + torch.exp(a - b))
    return reduce_masked_mean(loss, pos * valid) + reduce_masked_mean(loss, neg * valid), loss


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, vis: torch.Tensor,
                  valids: torch.Tensor, gamma: float = 0.8) -> torch.Tensor:
    """gamma-weighted L1 over refinement iterations: iteration i of I weighs
    gamma^(I-1-i), and the sum is divided by I. flow_preds (I, B, S, N, 2);
    flow_gt (B, S, N, 2); valids (B, S, N). ``vis`` is unused, as in JAX."""
    I = flow_preds.shape[0]
    i_weights = gamma ** torch.arange(I - 1, -1, -1, dtype=torch.float32,
                                      device=flow_preds.device)
    i_loss = (flow_preds - flow_gt[None]).abs().mean(dim=-1)  # (I, B, S, N)
    per_iter = reduce_masked_mean(i_loss, valids[None].expand_as(i_loss), axis=(1, 2, 3))
    return (per_iter * i_weights).sum() / I


def _score_map_selection(trajs_g, vis_g, valids, H8: int, W8: int):
    xy = torch.round(trajs_g)  # half to even, as jnp.round
    x, y = xy[..., 0], xy[..., 1]
    sel = ((x >= 0) & (x <= W8 - 1) & (y >= 0) & (y <= H8 - 1)
           & (valids > 0) & (vis_g > 0)).float()
    return x, y, sel


def score_map_loss_single_iter(fcp: torch.Tensor, trajs_g: torch.Tensor,
                               vis_g: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """Balanced BCE of one iteration's score maps fcp (B, S, N, H8, W8),
    trajs_g (B, S, N, 2) in feature-map coords.

    Exactly one cell of a selected map is positive, so
    neg_sum = sum softplus(z) - softplus(z[gt]) and pos = softplus(-z[gt]),
    with z[gt] read through separable row and column one-hots. Equals
    ``score_map_loss`` of the single iteration.
    """
    H8, W8 = fcp.shape[-2:]
    fcp = fcp.float()
    x, y, sel = _score_map_selection(trajs_g, vis_g, valids, H8, W8)
    oh_y = (torch.arange(H8, dtype=torch.float32, device=fcp.device) == y[..., None]).float()
    oh_x = (torch.arange(W8, dtype=torch.float32, device=fcp.device) == x[..., None]).float()
    sum_sp = F.softplus(fcp).sum(dim=(-2, -1))
    gt_val = torch.einsum("bsnhw,bsnh,bsnw->bsn", fcp, oh_y, oh_x)
    pos = F.softplus(-gt_val)
    neg_sum = sum_sp - F.softplus(gt_val)
    n_sel = mask_count(sel.sum())
    return ((pos * sel).sum() / (EPS + n_sel)
            + (neg_sum * sel).sum() / (EPS + n_sel * (H8 * W8 - 1)))


def score_map_loss(fcps: torch.Tensor, trajs_g: torch.Tensor, vis_g: torch.Tensor,
                   valids: torch.Tensor) -> torch.Tensor:
    """Balanced BCE between score maps fcps (B, S, I, N, H8, W8) and one-hot
    ground-truth cells; trajs_g (B, S, N, 2) in feature-map coords. Maps whose
    rounded position is out of bounds, occluded or invalid are left out."""
    B, S, I, N, H8, W8 = fcps.shape
    fcps = fcps.float()
    x, y, sel = _score_map_selection(trajs_g, vis_g, valids, H8, W8)
    hh = torch.arange(H8, dtype=torch.float32, device=fcps.device).reshape(1, 1, 1, H8, 1)
    ww = torch.arange(W8, dtype=torch.float32, device=fcps.device).reshape(1, 1, 1, 1, W8)
    gt = ((hh == y[..., None, None]) & (ww == x[..., None, None])).float()
    gt = gt[:, :, None].expand(B, S, I, N, H8, W8)
    selb = sel[:, :, None, :, None, None].expand(B, S, I, N, H8, W8)
    a = -(gt * 2.0 - 1.0) * fcps
    b = a.clamp_min(0.0)
    loss = b + torch.log(torch.exp(-b) + torch.exp(a - b))
    return reduce_masked_mean(loss, gt * selb) + reduce_masked_mean(loss, (1.0 - gt) * selb)
