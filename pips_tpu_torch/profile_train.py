"""Where a training step's time goes on the card.

    python3 -m pips_tpu_torch.profile_train [--bench] [--fuse-conv3] [--dtype float32]

Trains the flagship bf16 model (fused channel blocks, random weights from
seed 0; ``--dtype float32`` the f32 one, as ``--dtype float32 --fuse_chanff 1``
trains it, with PyTorch's default TF32 flags, printed) on a synthetic batch at the training default (B=1 doubled by both
flips to 4, N=768, I=4, 368x496; with ``--bench``, the bench train shape:
B=1, N=128, I=6, 384x512, no flips) and prints: the median host-clock step
of ``make_train_step`` over 5 steps after 2 of warm-up; the peak memory of
those steps; from ``torch.profiler``, one step's device time summed over
kernels and split into forward, backward and optimizer, the device's idle
share of the step, the kernels that take the most device time, and the time
of the channel block's forward and backward kernels (the backward by its
three launches) and of the stage-1 conv kernel. ``--fuse-conv3`` runs the
encoder's four stage-1 3x3 convs (and their dx) through
``csrc/conv3x3_fwd.cu``. CUDA only.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pips_tpu_torch import make_pips
from pips_tpu_torch.data import SyntheticPointDataset
from pips_tpu_torch.profile_window import summarize
from pips_tpu_torch.train import (apply_flip_doubling, make_optimizer, make_train_step,
                                  train_loss_fn)

DEFAULT = dict(N=768, iters=4, H=368, W=496, flips=(True, True))
BENCH = dict(N=128, iters=6, H=384, W=512, flips=(False, False))
RANGES = ("forward", "backward", "optimizer")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true", help="the bench train shape")
    ap.add_argument("--fuse-conv3", action="store_true",
                    help="the stage-1 3x3 convs through the conv kernel")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    cfg = BENCH if args.bench else DEFAULT

    model = make_pips(seed=0, dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
                      fuse_chanff=True, fuse_conv3=args.fuse_conv3).train()
    sample, _ = SyntheticPointDataset(S=8, N=cfg["N"], H=cfg["H"], W=cfg["W"], seed=1)[0]
    batch = {k: torch.from_numpy(v[None]).cuda() for k, v in sample.items()}
    opt = make_optimizer(model.parameters(), lr=5e-4, num_steps=100)
    step = make_train_step(model, opt, iters=cfg["iters"], horz_flip=cfg["flips"][0],
                           vert_flip=cfg["flips"][1])
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    step_ms = sorted(walls)[len(walls) // 2] * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same step, its three parts in annotated ranges, each ending in a sync
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.zero_grad()
        with record_function("forward"):
            loss, _ = train_loss_fn(model, apply_flip_doubling(batch, *cfg["flips"]),
                                    cfg["iters"])
            torch.cuda.synchronize()
        with record_function("backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("optimizer"):
            opt.step()
            torch.cuda.synchronize()

    B = batch["rgbs"].shape[0] * (1 + cfg["flips"][0]) * (1 + cfg["flips"][1])
    res = {"device": torch.cuda.get_device_name(0), "dtype": args.dtype,
           "fuse_conv3": args.fuse_conv3, "batch_after_flips": B, **cfg,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "step_ms_median": step_ms, "points_frames_per_s": B * cfg["N"] * 8 / step_ms * 1e3,
           "peak_memory_gb": peak_gb}
    res.update(summarize(prof, torch.autograd.DeviceType.CUDA, top=15, ranges=RANGES))
    res["idle_share"] = 1.0 - res["device_busy_ms"] / step_ms
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
