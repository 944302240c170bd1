#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pips_tpu_torch``): the quickest
proof that the port still starts, builds its kernels and serves on a GPU.

    python3 chip_smoke.py

Phases, each printing a progress line with the elapsed seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under pips_tpu_torch/csrc, with nvcc, timed;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with its tolerance, median time and bound;
  4. slice: the full-width bf16 PIPs model (S=8, mixer 512x12, fused channel
     blocks, onehot corr, 6 iterations) serves three windows through
     ``WindowTracker``; each must be finite, keep frame 0 at the queries,
     launch every kernel of the path, and agree with the same model run
     with the plain channel block.
Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failure exits non-zero before the last line; without CUDA it exits 2.
Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITERS = 6
DEPTH = 12
TOL_F32 = 1e-4  # kernel vs plain, f32: summation order over D=512 and F=2048 terms


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bf16_tol(ref_absmax: float) -> float:
    """Two bf16 ulps at the output's largest magnitude: the plain version
    rounds the fc1/fc2 products to bf16 before the f32 bias (as the JAX
    reference does), the kernel keeps them in f32; both round y once."""
    return 2.0 ** (math.ceil(math.log2(ref_absmax)) - 7)


def median_ms(torch, fn, args, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def chanff_args(torch, np, R: int, dtype, seed: int, D: int = 512, F: int = 2048):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(R, D), 1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D),
            rng.randn(D, F) / np.sqrt(D), 0.1 * rng.randn(F),
            rng.randn(F, D) / np.sqrt(F), 0.1 * rng.randn(D)]
    dts = [dtype, torch.float32, torch.float32, dtype, torch.float32, dtype, torch.float32]
    return [torch.from_numpy(v.astype(np.float32)).to("cuda", dt) for v, dt in zip(vals, dts)]


def chanff_bound(R: int, dtype: str, D: int = 512, F: int = 2048):
    """Least time for the block: 4RDF operations at the dtype's peak, or x and
    y once, both weights once and the f32 vectors once at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * R * D * F
    nbytes = 2 * R * D * esize + 2 * D * F * esize + 4 * (3 * D + F)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def plain_channel_blocks(mixer_module, reference):
    """Run the model's channel blocks through the plain version."""
    kernel = mixer_module.chan_ff_block
    mixer_module.chan_ff_block = reference
    try:
        yield
    finally:
        mixer_module.chan_ff_block = kernel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    import numpy as np

    from pips_tpu_torch import WindowTracker, grid_queries, make_pips
    from pips_tpu_torch.kernels import _build, mixer_cuda
    from pips_tpu_torch.models import mixer as mixer_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("device", f"{kind}; count {torch.cuda.device_count()}; torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t = time.perf_counter()
    info = _build.build_all()
    for stem, i in info.items():
        log("build", f"{stem}: {'cached' if i['cached'] else 'built'} in {i['seconds']:.2f} s "
                     f"-> {i['path']}")
    log("build", f"all kernels ready in {time.perf_counter() - t:.2f} s")

    # 3. kernels against their plain versions, at the main path's shapes
    R_MAIN = 1 * 256 * 8  # B*N*S of the first request
    chanff = {}
    for dtype in ("bfloat16", "float32"):
        for R in (R_MAIN, 2000):
            args = chanff_args(torch, np, R, getattr(torch, dtype), seed=R)
            y = mixer_cuda.chan_ff_block(*args)
            torch.cuda.synchronize()
            ref = mixer_cuda.chan_ff_reference(*args)
            err = (y.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = bf16_tol(ref_max) if dtype == "bfloat16" else TOL_F32
            ms = median_ms(torch, mixer_cuda.chan_ff_block, args)
            plain_ms = median_ms(torch, mixer_cuda.chan_ff_reference, args)
            bound_ms, bound_by = chanff_bound(R, dtype)
            log("kernels", f"chan_ff_block {dtype} R={R}: max_abs_err {err:.3g} (tol {tol:.3g}, "
                           f"|y| <= {ref_max:.3g}); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                           f"bound {bound_ms:.4f} ms ({bound_by})")
            if not (y.shape == ref.shape and err <= tol):
                fail(f"chan_ff_block {dtype} R={R} disagrees with its plain version: {err} > {tol}")
            chanff[(dtype, R)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)

    # 4. slice: the served windows
    t = time.perf_counter()
    model = make_pips(device="cuda", seed=0, dtype=torch.bfloat16, fuse_chanff=True)
    tracker = WindowTracker(model, iters=ITERS, corr_mode="onehot")
    log("slice", f"full-width bf16 Pips on cuda in {time.perf_counter() - t:.1f} s "
                 f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    rng = np.random.RandomState(0)
    requests = []
    H, W = 480, 1024
    requests.append(("N=256 random @480x1024", rng.rand(1, 8, H, W, 3) * 255,
                     rng.rand(1, 256, 2) * [W - 8, H - 8] + 4))
    requests.append(("grid_queries(384, 512) @384x512", rng.rand(1, 8, 384, 512, 3) * 255,
                     grid_queries(384, 512)))
    requests.append(("N=100 random @256x384", rng.rand(1, 8, 256, 384, 3) * 255,
                     rng.rand(1, 100, 2) * [384 - 8, 256 - 8] + 4))
    requests = [(name, rgbs.astype(np.float32), xys.astype(np.float32))
                for name, rgbs, xys in requests]

    mixer_cuda.launches = 0  # counts from here to the end of the main path only
    served = []
    for name, rgbs, xys in requests:
        before = mixer_cuda.launches
        trajs, vis = tracker(xys, rgbs)
        n_launch = mixer_cuda.launches - before
        N = xys.shape[1]
        if trajs.shape != (1, 8, N, 2) or vis.shape != (1, 8, N):
            fail(f"{name}: shapes {trajs.shape}, {vis.shape}")
        if not (np.isfinite(trajs).all() and np.isfinite(vis).all()):
            fail(f"{name}: non-finite output")
        if not np.array_equal(trajs[:, 0], xys):
            fail(f"{name}: frame 0 is not locked at the queries")
        if n_launch != DEPTH * ITERS:
            fail(f"{name}: chan_ff_block launched {n_launch} times, expected {DEPTH * ITERS}")
        served.append((name, rgbs, xys, trajs, vis, n_launch))
    launches = mixer_cuda.launches

    # the same model with the plain channel block (LN, GELU, residual in f32
    # on the same bf16 operands). One iteration agrees within bf16 rounding;
    # six iterate corr lookups through floor() with untrained weights, which
    # amplifies any difference (docs/TESTING.md, "Numerical-chaos policy"),
    # so the served window is held to a bounded drift.
    tracker1 = WindowTracker(model, iters=1, corr_mode="onehot")
    for name, rgbs, xys, trajs, vis, n_launch in served:
        k1 = tracker1(xys, rgbs)
        with plain_channel_blocks(mixer_module, mixer_cuda.chan_ff_reference):
            p1 = tracker1(xys, rgbs)
            p6 = tracker(xys, rgbs)
        d1 = np.abs(k1[0] - p1[0])
        v1 = np.abs(k1[1] - p1[1])
        d6 = np.abs(trajs - p6[0])
        v6 = np.abs(vis - p6[1])
        moved = np.abs(trajs - xys[:, None]).max()
        log("slice", f"{name}: {n_launch} launches; moved up to {moved:.1f} px; vs plain block: "
                     f"1 iter traj max {d1.max():.3g} px, vis max {v1.max():.3g}; "
                     f"6 iters traj median {np.median(d6):.3g} px, p90 "
                     f"{np.percentile(d6, 90):.3g}, max {d6.max():.3g}, vis median "
                     f"{np.median(v6):.3g}")
        if not (d1.max() < 1.0 and v1.max() < 0.25):
            fail(f"{name}: one iteration differs from the plain block beyond 1 px / 0.25")
        if not (np.median(d6) < 2.0 and np.percentile(d6, 90) < 8.0 and np.median(v6) < 0.5):
            fail(f"{name}: six iterations drift from the plain block beyond the bound")

    name, rgbs, xys = requests[0]
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tracker(xys, rgbs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    window_s = sorted(times)[len(times) // 2]
    N = xys.shape[1]
    log("slice", f"{name}: median window {window_s * 1e3:.2f} ms over {len(times)}, "
                 f"{N * 8 / window_s:.0f} points*frames/s (host clock, frames uploaded each call)")

    main_case = chanff[("bfloat16", R_MAIN)]
    print(json.dumps({"kernels": [{
        "name": "chan_ff_block", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_fwd.cu",
        "replaces": "pips_tpu/kernels/mixer_pallas.py:216", "launches": launches,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
