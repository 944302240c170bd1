"""Where the RAFT and DINO baselines' time goes at a frame size.

    python3 -m pips_tpu_torch.profile_baselines [--hw 1080 1920] [--iters 32]

Times, on the host clock ending in a device sync (the median of ``--reps``
after one warm-up call), at the given frame size in f32 with seeded weights:
one RAFT frame pair (the encoders and the all-pairs pyramid alone, then with
``--iters`` update iterations), with cuDNN's convs in TF32 (PyTorch's
default, as the runners run) and without; DINO's ViT-S/8 on an 8-frame
window; and one target frame's label propagation against 8 source frames.
Prints one JSON object with the card's name and power limit and the peak
memory. CUDA unless ``main(device="cpu")``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from pips_tpu_torch.models.dino import ViT, label_propagation
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.models.raft import RAFT


def seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights normal over their fan-in (the last axis is the output of a
    flax-layout kernel), norm scales 1, biases 0: timing weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias"):
                p.fill_(1.0 if leaf == "scale" else 0.0)
            else:
                fan_in = p[0].numel() if leaf == "weight" else max(p.numel() // p.shape[-1], 1)
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    return model


def timed(fn, device, reps: int) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fn()
    secs = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        secs.append(time.perf_counter() - t)
    return statistics.median(secs)


def main(hw=(1080, 1920), iters: int = 32, reps: int = 3, device="cuda") -> dict:
    device = resolve_device(device)
    H, W = hw
    gen = torch.Generator().manual_seed(0)
    secs: dict[str, float] = {}
    out = {"hw": [H, W], "iters": iters, "seconds": secs}
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        torch.cuda.reset_peak_memory_stats()
    raft = seeded(RAFT(), 1).to(device).eval()
    a = (torch.rand(1, H, W, 3, generator=gen) * 255).to(device)
    b = torch.roll(a, (1, 3), (1, 2))
    old = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            for n in (0, iters):
                with torch.inference_mode():
                    s = timed(lambda n=n: raft(a, b, iters=n), device, reps)
                secs[f"raft pair, {n} iters, cudnn tf32 {tf32}"] = s
    finally:
        torch.backends.cudnn.allow_tf32 = old
    del raft, a, b
    vit = seeded(ViT(grid_hw=(H // 8, W // 8)), 2).to(device).eval()
    x = torch.randn(8, H, W, 3, generator=gen).to(device)
    with torch.inference_mode():
        secs["vit, 8 frames"] = timed(lambda: vit(x), device, reps)
        feats = vit(x[:1]).expand(8, -1, -1) + 0.1 * torch.randn(
            8, (H // 8) * (W // 8), vit.dim, generator=gen).to(device)
    segs = torch.rand(8, 16, H // 8, W // 8, generator=gen).to(device)
    secs["label_propagation, 8 sources"] = timed(
        lambda: label_propagation(feats[0], feats.transpose(1, 2), segs, 12, H // 8, W // 8),
        device, reps)
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(1080, 1920))
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(main(tuple(args.hw), args.iters, args.reps)))
