"""The training step (counterpart of ``pips_tpu/train/step.py``).

Flip doubling, the forward with the score-map CE summed in the loop,
loss = seq + 10 * vis + ce with the ATE metrics, gradient accumulation that
sums the microbatches' grads (as ``backward()`` does), then the optimizer's
clip and AdamW update.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from pips_tpu_torch.models.losses import balanced_ce_loss, sequence_loss
from pips_tpu_torch.ops.reduce import reduce_masked_mean

Batch = Dict[str, torch.Tensor]
BATCH_KEYS = ("rgbs", "trajs", "visibles", "valids")


def apply_flip_doubling(batch: Batch, horz_flip: bool, vert_flip: bool) -> Batch:
    """Concatenate flipped copies along the batch: horizontal first, then
    vertical (which flips the horizontal copies too), so B becomes up to B*4."""

    def flip(b: Batch, dim: int, coord: int, size: int) -> Batch:
        out = dict(b)
        out["rgbs"] = torch.flip(b["rgbs"], dims=(dim,))
        trajs = b["trajs"].clone()
        trajs[..., coord] = size - 1 - b["trajs"][..., coord]
        out["trajs"] = trajs
        return out

    def cat(a: Batch, b: Batch) -> Batch:
        return {k: torch.cat([a[k], b[k]], dim=0) for k in a}

    H, W = batch["rgbs"].shape[2], batch["rgbs"].shape[3]
    if horz_flip:
        batch = cat(batch, flip(batch, dim=3, coord=0, size=W))
    if vert_flip:
        batch = cat(batch, flip(batch, dim=2, coord=1, size=H))
    return batch


def train_loss_fn(model, batch: Batch, iters: int, is_train: bool = True):
    """(total_loss, metrics) of one batch: rgbs (B, S, H, W, 3) in [0, 255],
    trajs (B, S, N, 2), visibles and valids (B, S, N)."""
    rgbs, trajs_g = batch["rgbs"], batch["trajs"]
    vis_g, valids = batch["visibles"], batch["valids"]
    out = model(trajs_g[:, 0], rgbs, iters=iters, is_train=is_train, compute_fcp=True,
                ce_gt=(trajs_g, vis_g, valids))
    seq_loss = sequence_loss(out.coord_predictions, trajs_g, vis_g, valids, 0.8)
    vis_loss, _ = balanced_ce_loss(out.vis_e, vis_g, valids)
    ce_loss = out.ce_loss if out.ce_loss is not None else torch.zeros((), device=rgbs.device)
    total_loss = seq_loss + vis_loss * 10.0 + ce_loss
    ate = torch.linalg.vector_norm(out.coord_predictions[-1] - trajs_g, dim=-1)  # (B, S, N)
    metrics = {
        "total_loss": total_loss,
        "seq": seq_loss,
        "vis": vis_loss,
        "ce": ce_loss,
        "ate_all": reduce_masked_mean(ate, valids),
        "ate_vis": reduce_masked_mean(ate, valids * vis_g),
        "ate_occ": reduce_masked_mean(ate, valids * (1.0 - vis_g)),
    }
    return total_loss, metrics


def make_train_step(model, optimizer, iters: int = 4, horz_flip: bool = True,
                    vert_flip: bool = True, grad_acc: int = 1, remat: bool = False,
                    sync_metrics: bool = True) -> Callable[[Batch], Dict[str, float]]:
    """``step(batch) -> metrics``: one optimizer step of ``model``.

    ``batch`` holds numpy arrays or tensors (moved to the model's device as
    f32); with ``grad_acc > 1`` each has a leading (grad_acc,) microbatch axis,
    the microbatches' grads are summed and their metrics averaged. ``remat``
    recomputes the whole forward in the backward. Metrics come back as floats,
    which waits for the step to finish on the device; with
    ``sync_metrics=False`` as 0-d tensors on the device, so a loop can read
    them only every few steps.
    """

    def loss_for_grad(mb: Batch):
        return train_loss_fn(model, apply_flip_doubling(mb, horz_flip, vert_flip), iters)

    if remat:
        inner = loss_for_grad

        def loss_for_grad(mb: Batch):
            return checkpoint(inner, mb, use_reentrant=False)

    def step(batch: Batch) -> Dict[str, float]:
        device = next(model.parameters()).device
        batch = {k: torch.as_tensor(batch[k], dtype=torch.float32).to(device)
                 for k in BATCH_KEYS}
        micro = [batch] if grad_acc == 1 else [{k: v[i] for k, v in batch.items()}
                                               for i in range(grad_acc)]
        optimizer.zero_grad()
        sums = None
        for mb in micro:
            loss, metrics = loss_for_grad(mb)
            loss.backward()
            m = {k: v.detach() for k, v in metrics.items()}
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        optimizer.step()
        if not sync_metrics:
            return {k: v / len(micro) for k, v in sums.items()}
        return {k: float(v) / len(micro) for k, v in sums.items()}

    return step
