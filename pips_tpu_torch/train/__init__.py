"""Training (counterpart of ``pips_tpu/train``): the step, loss and optimizer."""

from pips_tpu_torch.train.optim import (Optimizer, clip_by_global_norm_, make_optimizer,
                                        onecycle_linear)
from pips_tpu_torch.train.step import apply_flip_doubling, make_train_step, train_loss_fn

__all__ = ["Optimizer", "apply_flip_doubling", "clip_by_global_norm_", "make_optimizer",
           "make_train_step", "onecycle_linear", "train_loss_fn"]
