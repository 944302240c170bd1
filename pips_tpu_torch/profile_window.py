"""Where a served window's time goes on the card.

    python3 -m pips_tpu_torch.profile_window [--corr-mode pallas] [--dense] [--fuse-conv3]

Serves the flagship bf16 window (the first request of ``chip_smoke.py``:
N=256 random queries at 480x1024, 6 iterations; with ``--dense``, the dense
probe's N=7680 queries, one every 8 pixels) with the given corr mode
(default ``onehot``) and prints: the window's host-clock time with the
frames already on the card; from ``torch.profiler``, the device time summed
over kernels, split into encode and track, and the device's idle share of
that window; the kernels that take the most device time; and the time of
the fused channel block (in all and by its three launches), of the corr
kernel and of the stage-1 conv kernel.
``--fuse-conv3`` runs the encoder's four stage-1 3x3 convs through
``csrc/conv3x3_fwd.cu``, so the encode range reads with and without it.
CUDA only.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pips_tpu_torch import WindowTracker, dense_queries, make_pips
from pips_tpu_torch.models.pips import CORR_MODES


def summarize(prof, device_type, top: int, ranges=("encode", "track")) -> dict:
    """Device time of a profiled run: total, split by annotated range (each
    range ends in a sync, so a kernel belongs to the last range that started
    before it), by kernel name, and the time of the port's kernels."""
    # the profiler also lists the annotations on the device: ours and the optimizer's
    kernels = [e for e in prof.events() if e.device_type == device_type
               and e.name not in ranges and not e.name.startswith("Optimizer.")]
    starts = sorted((min(e.time_range.start for e in prof.events() if e.name == r), r)
                    for r in ranges)
    by_name: dict[str, list] = {}
    split = {r: 0.0 for r in ranges}
    for e in kernels:
        us = e.time_range.elapsed_us()
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += us
        s[1] += 1
        owner = starts[0][1]
        for start, r in starts:
            if start <= e.time_range.start:
                owner = r
        split[owner] += us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # the channel block's launches, by kernel name: the forward's, the backward's
    chanff: dict[str, dict[str, float]] = {"fwd": {}, "bwd": {}}
    for k, v in by_name.items():
        m = re.search(r"chanff_(fwd|bwd)_\w+", k)
        if m:
            part = chanff[m.group(1)]
            part[m.group(0)] = part.get(m.group(0), 0.0) + v[0] / 1e3
    return {
        "device_busy_ms": sum(split.values()) / 1e3,
        "device_ms_by_range": {k: v / 1e3 for k, v in split.items()},
        "kernel_launches": len(kernels),
        "chanff_ms": sum(v[0] for k, v in by_name.items() if "chanff_fwd" in k) / 1e3,
        "chanff_fwd_ms": chanff["fwd"],
        "chanff_bwd_ms": chanff["bwd"],
        "corr_sample_ms": sum(v[0] for k, v in by_name.items() if "corr_sample" in k) / 1e3,
        "conv3x3_ms": sum(v[0] for k, v in by_name.items() if "conv3x3_" in k) / 1e3,
        "conv3x3_launches": sum(v[1] for k, v in by_name.items() if "conv3x3_" in k),
        "top_kernels": [{"name": k[:90], "ms": v[0] / 1e3, "count": v[1]} for k, v in ranked],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corr-mode", default="onehot", choices=CORR_MODES)
    ap.add_argument("--dense", action="store_true", help="N=7680 queries, one every 8 px")
    ap.add_argument("--fuse-conv3", action="store_true",
                    help="the stage-1 3x3 convs through the conv kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_window needs a CUDA device")

    H, W = 480, 1024
    rng = np.random.RandomState(0)
    rgbs = (rng.rand(1, 8, H, W, 3) * 255).astype(np.float32)
    if args.dense:
        xys = dense_queries(H, W).astype(np.float32)
    else:
        xys = (rng.rand(1, 256, 2) * [W - 8, H - 8] + 4).astype(np.float32)
    N = xys.shape[1]
    tracker = WindowTracker(make_pips(seed=0, dtype=torch.bfloat16, fuse_chanff=True,
                                      fuse_conv3=args.fuse_conv3),
                            iters=6, corr_mode=args.corr_mode)
    frames = torch.from_numpy(rgbs).cuda()

    def window():
        tracker.track(tracker.encode(frames), xys)
        torch.cuda.synchronize()

    for _ in range(3):
        window()
    walls = []
    for _ in range(7):
        t = time.perf_counter()
        window()
        walls.append(time.perf_counter() - t)
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with record_function("encode"):
            fmaps = tracker.encode(frames)
            torch.cuda.synchronize()
        t_enc = time.perf_counter()
        with record_function("track"):
            tracker.track(fmaps, xys)
            torch.cuda.synchronize()
        t_end = time.perf_counter()

    res = {"device": torch.cuda.get_device_name(0), "corr_mode": args.corr_mode,
           "fuse_conv3": args.fuse_conv3, "n": N,
           "hw": [H, W],
           "window_ms_median_frames_on_device": wall_ms,
           "profiled_wall_ms": {"encode": (t_enc - t) * 1e3, "track": (t_end - t_enc) * 1e3}}
    res.update(summarize(prof, torch.autograd.DeviceType.CUDA, top=12))
    # against the unprofiled window: the profiler's own host cost would inflate it
    res["idle_share"] = 1.0 - res["device_busy_ms"] / wall_ms
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
