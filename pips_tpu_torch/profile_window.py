"""Where a served window's time goes on the card.

    python3 -m pips_tpu_torch.profile_window

Serves the flagship bf16 window (the first request of ``chip_smoke.py``:
N=256 random queries at 480x1024, 6 iterations) and
prints: the window's host-clock time with the frames already on the card;
from ``torch.profiler``, the device time summed over kernels, split into
encode and track, and the device's idle share of that window; the kernels
that take the most device time; and the fused channel block's share.
CUDA only.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pips_tpu_torch import WindowTracker, make_pips


def summarize(prof, device_type, top: int) -> dict:
    """Device time of a profiled window: total, split at the start of the
    ``track`` range (encode ends in a sync, so no encode kernel runs after
    it), by kernel name, and the fused channel block's share."""
    ranges = ("encode", "track")  # the profiler also lists these annotations on the device
    kernels = [e for e in prof.events() if e.device_type == device_type and e.name not in ranges]
    track_start = min(e.time_range.start for e in prof.events() if e.name == "track")
    by_name: dict[str, list] = {}
    split = {"encode": 0.0, "track": 0.0}
    for e in kernels:
        us = e.time_range.elapsed_us()
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += us
        s[1] += 1
        split["encode" if e.time_range.start < track_start else "track"] += us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_busy_ms": sum(split.values()) / 1e3,
        "device_ms_by_range": {k: v / 1e3 for k, v in split.items()},
        "kernel_launches": len(kernels),
        "chanff_ms": sum(v[0] for k, v in by_name.items() if "chanff" in k) / 1e3,
        "top_kernels": [{"name": k[:90], "ms": v[0] / 1e3, "count": v[1]} for k, v in ranked],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_window needs a CUDA device")

    H, W, N = 480, 1024, 256
    rng = np.random.RandomState(0)
    rgbs = (rng.rand(1, 8, H, W, 3) * 255).astype(np.float32)
    xys = (rng.rand(1, N, 2) * [W - 8, H - 8] + 4).astype(np.float32)
    tracker = WindowTracker(make_pips(seed=0, dtype=torch.bfloat16, fuse_chanff=True),
                            iters=6, corr_mode="onehot")
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

    res = {"device": torch.cuda.get_device_name(0), "n": N, "hw": [H, W],
           "window_ms_median_frames_on_device": wall_ms,
           "profiled_wall_ms": {"encode": (t_enc - t) * 1e3, "track": (t_end - t_enc) * 1e3}}
    res.update(summarize(prof, torch.autograd.DeviceType.CUDA, top=12))
    # against the unprofiled window: the profiler's own host cost would inflate it
    res["idle_share"] = 1.0 - res["device_busy_ms"] / wall_ms
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
