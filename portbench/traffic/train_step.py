"""Closed-loop training: one trainer calls the port's ``make_train_step`` step
after step, as ``train/loop.py`` does, on batches already on the card.

The workload file's ``params``: ``B`` clips a step of ``N`` points, S frames
at ``H`` x ``W`` from the frozen synthetic generator (``pool_clips`` of them,
``sprites`` sprites of ``sprite_size`` px moving up to ``max_vel`` px a
frame), made at set-up, moved to the card and cycled; ``iters`` refinement
iterations; the flips (each doubles the batch); AdamW's ``lr`` and
``num_steps``. Set-up makes one step object (model and optimizer state) and
drives it through its first ``checked_steps`` steps, each on its own clip;
the plain reference follows those steps from the same weights, and the same
object then runs the measured window. When asked, ``profiled_calls`` more
whole steps are traced, then ``profiled_steps`` split into forward,
backward and optimizer.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from portbench import common, trace
from portbench.reference import pips as ref
from portbench.reference.params import make_params
from portbench.roofline import forward_flops

PARTS = ("forward", "backward", "optimizer")
KEYS = ("rgbs", "trajs", "visibles", "valids")
TERMS = ("total_loss", "seq", "vis", "ce")


def clips(p: dict, S: int, seed: int) -> list:
    """The pool: each clip a dict of (1, ...) float32 numpy arrays."""
    return [{k: c[k][None] for k in KEYS} for c in common.clip_pool(p, S, seed, N=p["N"])]


def first_steps(step, opt, model, batches: list) -> dict:
    """Drive the step through one step a batch, as the window calls it, and
    keep what the check compares: each step's loss, the first gradient as the
    optimizer got it (AdamW's first moment after one step over 1 - beta1),
    and each parameter's change over all of them."""
    import torch

    named = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in named.items()}
    losses, grads = [], None
    for i, batch in enumerate(batches):
        m = step(batch)
        losses.append([m[k] for k in TERMS])
        if i == 0:  # a zero gradient where the step left no state
            beta1 = opt.adamw.param_groups[0]["betas"][0]
            grads = {k: (opt.adamw.state[v]["exp_avg"] / (1.0 - beta1)).cpu()
                     if "exp_avg" in opt.adamw.state.get(v, {}) else torch.zeros(v.shape)
                     for k, v in named.items()}
    change = {k: float((v.detach() - start[k]).norm()) for k, v in named.items()}
    return {"losses": [[float(x) for x in t] for t in losses], "first_grad": grads,
            "grad_norms": {k: float(v.norm()) for k, v in grads.items()},
            "change_norms": change}


def reference_steps(ctx, batches: list, precision: str = "float32") -> dict:
    """The same steps by the plain reference, from the same weights."""
    import torch
    from torch.utils.checkpoint import checkpoint

    p, cfg = ctx.params, ctx.model
    params = make_params(cfg, common.seeds(ctx.seed)["weights"], ctx.device)
    start = {k: v.clone() for k, v in params.items()}
    adam = ref.AdamW(params, p["lr"], p["num_steps"])
    prec = ref.Precision(precision)

    def block(fn, x):
        return checkpoint(fn, x, use_reentrant=False)

    losses, grads = [], None
    with ref.reference_mode():
        for i, batch in enumerate(batches):
            for v in params.values():
                v.requires_grad_(True)
            b = {k: torch.as_tensor(batch[k]).to(ctx.device) for k in KEYS}
            flip = (p["horz_flip"], p["vert_flip"])
            if flip != (True, True):
                raise ValueError("the reference doubles the batch by both flips")
            loss, terms = ref.train_loss(params, cfg, b, p["iters"], prec, block=block)
            g = torch.autograd.grad(loss, list(params.values()))
            for v in params.values():
                v.requires_grad_(False)
            used = adam.step(dict(zip(params, g)))
            losses.append([loss.item()] + [terms[k].item() for k in TERMS[1:]])
            if i == 0:
                grads = {k: v.cpu() for k, v in used.items()}
            del loss, terms, g, used
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "first_grad": grads,
            "grad_norms": {k: float(v.norm()) for k, v in grads.items()},
            "change_norms": change}


def compare(prog: dict, refr: dict) -> dict:
    """Over the leaves (parameters) whose reference gradient is at least a
    thousandth of the median leaf's (the rest, such as the biases ahead of
    an instance norm, are zero but for rounding and move by Adam's
    normalised step alone): by the worst leaf, the gap between the two
    sides' norms of the first gradient, and of each parameter's change over
    the steps, each over the larger of that leaf's and the median leaf's
    reference norm; and the median leaf's norm of the first gradients'
    difference over its reference norm.

    A norm's gap is second order in an error spread over a leaf, and the
    worst leaf's difference is an early encoder conv's, whose gradient
    cancels over the pixels (bf16 alone moves it by a third), so neither
    told the float8 control from sound runs; the median leaf's difference
    does. The losses are not held: with these weights their L1 term barely
    depends on the model, and no control or fault moved them three (ten)
    times as far as sound runs (PERF.md)."""
    g_ref = refr["grad_norms"]
    g_med = statistics.median(g_ref.values())
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]

    def worst(key):
        med = statistics.median(refr[key][k] for k in kept)
        return max(abs(prog[key][k] - refr[key][k]) / max(refr[key][k], med) for k in kept)

    diff = statistics.median(float((prog["first_grad"][k] - refr["first_grad"][k]).norm())
                             / g_ref[k] for k in kept)
    return {"grad_diff_median": diff, "grad_norm_gap": worst("grad_norms"),
            "change_norm_gap": worst("change_norms")}


def profile(ctx, step, model, opt, batches: list) -> dict:
    """Two profiled sections after the window, in one profiler session
    (``trace.profiled``). ``profiled_calls`` whole
    ``step(batch)`` calls, as the window makes them, a mark between steps
    and no sync until the last: the kernels and the device's idle share
    come from these. Then ``profiled_steps`` steps split into the forward
    (with the loss), the backward and the optimizer step, each ending in a
    sync (``pips_tpu_torch/profile_train.py``'s split): the device time of
    each part comes from these."""
    import torch
    from pips_tpu_torch.kernels import mixer_cuda
    from pips_tpu_torch.train import apply_flip_doubling, train_loss_fn

    p = ctx.params
    dev = torch.device(ctx.device)
    state = {}

    def call(i, _):
        n = mixer_cuda.launches, mixer_cuda.bwd_launches
        step(batches[i % len(batches)])
        if i < 0:  # every step makes the same calls
            state["chanff"] = (mixer_cuda.launches - n[0], mixer_cuda.bwd_launches - n[1])

    def part(i, name):
        if name == "forward":
            opt.zero_grad()
            batch = apply_flip_doubling(batches[(i + 1) % len(batches)], p["horz_flip"],
                                        p["vert_flip"])
            state["loss"] = train_loss_fn(model, batch, p["iters"])[0]
        elif name == "backward":
            state.pop("loss").backward()
        else:
            opt.step()
        common.sync(dev)

    whole, split = trace.profiled(dev, [(("call",), p["profiled_calls"], call),
                                        (PARTS, p["profiled_steps"], part)])
    fwd, bwd = state["chanff"]
    return {"calls": whole, "parts": split, "chanff_fwd_calls": fwd * p["profiled_calls"],
            "chanff_bwd_calls": bwd * p["profiled_calls"]}


def run(ctx) -> dict:
    import torch
    from pips_tpu_torch.train import make_optimizer, make_train_step

    p, cfg = ctx.params, ctx.model
    s = common.seeds(ctx.seed)
    model = common.build_model(cfg, make_params(cfg, s["weights"], ctx.device), ctx.device,
                               train=True)
    opt = make_optimizer(model.parameters(), lr=p["lr"], num_steps=p["num_steps"])
    step = make_train_step(model, opt, iters=p["iters"], horz_flip=p["horz_flip"],
                           vert_flip=p["vert_flip"], sync_metrics=False)
    pool = clips(p, cfg["S"], s["traffic"])
    batches = [{k: torch.from_numpy(c[k]).to(ctx.device) for k in KEYS} for c in pool]
    checked = p["checked_steps"]
    prog = first_steps(step, opt, model, batches[:checked])
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0
    steps, start = 0, time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        step(batches[(checked + steps) % len(batches)])
        steps += 1
    common.sync(ctx.device)
    window_s = time.perf_counter() - start
    peak = common.peak_bytes(ctx.device)
    traced = profile(ctx, step, model, opt, batches) if ctx.trace else None
    del model, opt, step, batches
    common.free(ctx.device)
    failed = sum(not np.isfinite(x[0]) for x in prog["losses"])
    gaps = compare(prog, reference_steps(ctx, pool[:checked]))
    limits = ctx.work["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    B = p["B"] * (1 + p["horz_flip"]) * (1 + p["vert_flip"])
    return {"kind": "train_step", "correct": common.judged(checks, failed),
            "attempted": checked + steps, "failed": failed, "checks": checks,
            "setup_s": setup_s, "window_s": window_s, "units": steps,
            "point_frames": B * p["N"] * cfg["S"] * steps,
            "chanff_rows": B * p["N"] * cfg["S"], "dtype": cfg["dtype"],
            "forward_flops": forward_flops(cfg, B, cfg["S"], p["H"], p["W"], p["N"], p["iters"],
                                           train=True),
            "trace": traced,
            "device": common.device_info(ctx.device, ctx.cell["chips"], peak)}

