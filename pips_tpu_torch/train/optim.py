"""Optimizer and learning-rate schedule (counterpart of ``pips_tpu/train/optim.py``).

Global-norm clipping at 5.0, then AdamW(betas 0.9/0.999, eps 1e-8, weight
decay 1e-4) under a OneCycle schedule with linear warm-up and annealing. The
schedule is the JAX package's optax ``join_schedules`` of two
``linear_schedule``s, evaluated in f32 as optax does, and drives a
``LambdaLR`` over a base rate of 1, so the rate AdamW uses is the schedule's
value itself. Clipping is optax's: g * (max_norm / |g|) only when
|g| >= max_norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def _linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule in f32: (init - end) * (1 - count / T) + end,
    count clipped to [0, T]."""
    diff = np.float32(init_value - end_value)
    end = np.float32(end_value)
    steps = np.float32(transition_steps)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        return float(diff * (np.float32(1.0) - c / steps) + end)

    return schedule


def onecycle_linear(max_lr: float, total_steps: int, pct_start: float = 0.05,
                    div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Callable[[int], float]:
    """The rate at each optimizer step: linear warm-up from max_lr/div_factor
    to max_lr over max(round(pct_start * total_steps), 1) steps, then linear
    annealing to max_lr/div_factor/final_div_factor. A ``LambdaLR`` lambda
    (over a base rate of 1)."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    warmup = max(int(round(pct_start * total_steps)), 1)
    up = _linear_schedule(initial_lr, max_lr, warmup)
    down = _linear_schedule(max_lr, min_lr, max(total_steps - warmup, 1))
    return lambda step: up(step) if step < warmup else down(step - warmup)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the grads in place by max_norm / |g| when the global norm |g| of
    all of them is at least max_norm, as optax.clip_by_global_norm. The test
    runs on the device, so the host never waits for |g|. Returns |g|, a 0-d
    tensor."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    torch._foreach_mul_(grads, torch.where(norm >= max_norm, max_norm / norm,
                                           torch.ones_like(norm)))
    return norm


class Optimizer:
    """Clip -> AdamW under the schedule, over the parameters that require grad.

    ``zero_grad()`` before the backward; ``step()`` clips, updates and
    advances the schedule. ``lr`` is the rate the next step will use."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule, wdecay: float = 1e-4,
                 eps: float = 1e-8, clip: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        constant = not callable(schedule)
        self.adamw = torch.optim.AdamW(self.params, lr=float(schedule) if constant else 1.0,
                                       betas=(0.9, 0.999), eps=eps, weight_decay=wdecay)
        self.scheduler = (None if constant else
                          torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule))

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update; returns the global grad norm before clipping, a 0-d
        tensor (reading it waits for the device)."""
        norm = clip_by_global_norm_(self.params, self.clip)
        self.adamw.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return norm

    def state_dict(self) -> dict:
        """AdamW's moments and step counts, and the schedule's position: what a
        checkpoint needs to resume the optimizer exactly."""
        return {"adamw": self.adamw.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])

    @torch.no_grad()
    def load_optax_state(self, params: dict[str, torch.nn.Parameter], mu: dict, nu: dict,
                         count: int, schedule_count: int) -> None:
        """Take the state of the JAX package's optax chain (clip, which keeps
        none, then adamw): ``mu`` and ``nu`` (keyed as ``params``, in their
        layout) become each parameter's ``exp_avg`` and ``exp_avg_sq``, the
        Adam ``count`` its step, and the schedule's ``count`` the position in
        the schedule, so the next step uses the rate and the bias corrections
        the JAX step would."""
        for name, p in params.items():
            self.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(mu[name]).to(p.device, p.dtype).clone(),
                "exp_avg_sq": torch.as_tensor(nu[name]).to(p.device, p.dtype).clone()}
        if self.scheduler is not None:
            lrs = [base * fn(schedule_count) for base, fn in
                   zip(self.scheduler.base_lrs, self.scheduler.lr_lambdas)]
            state = self.scheduler.state_dict()
            state.update(last_epoch=schedule_count, _last_lr=lrs)
            self.scheduler.load_state_dict(state)
            for group, lr in zip(self.adamw.param_groups, lrs):
                group["lr"] = lr


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, num_steps: int,
                   wdecay: float = 1e-4, eps: float = 1e-8, clip: float = 5.0,
                   use_scheduler: bool = True) -> Optimizer:
    """Clip -> AdamW(onecycle_linear(lr, num_steps + 100)); ``num_steps`` counts
    optimizer steps (after gradient accumulation). The ``+ 100`` is the
    reference trainer's, kept by the JAX package."""
    schedule = onecycle_linear(lr, num_steps + 100) if use_scheduler else lr
    return Optimizer(params, schedule, wdecay=wdecay, eps=eps, clip=clip)
