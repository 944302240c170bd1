#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pips_tpu_torch``): the quickest
proof that the port still starts, builds its kernels and serves on a GPU.

    python3 chip_smoke.py

Phases, each printing a progress line with the elapsed seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under pips_tpu_torch/csrc, with nvcc, timed;
  3. kernels: each kernel against its plain PyTorch version at the main
     paths' shapes, with its tolerance, median time and bound:
     ``chan_ff_block`` (fused channel block) and ``corr_sample`` (fused corr
     sampler, three point counts by three dtype pairs);
  4. slice, onehot windows: the full-width bf16 PIPs model (S=8, mixer
     512x12, fused channel blocks, 6 iterations) serves three windows through
     ``WindowTracker(corr_mode="onehot")``; each must be finite, keep frame 0
     at the queries, launch every kernel of the path, and agree with the same
     model run with the plain channel block;
  5. slice, pallas windows: the same three requests and a dense probe
     (N=7680 at 480x1024) through ``WindowTracker(corr_mode="pallas")``, which
     samples the correlation through the corr kernel; each must launch it
     once per iteration and agree with ``corr_mode="fused"`` (its plain
     version); window times beside the onehot path's, taken in turns;
  6. slice, chained video: ``ChainTracker(corr_mode="pallas")`` tracks 256
     points through 32 frames at 360x640 with ``track_video`` and
     ``track_stream`` (which must agree), then with a fixed skip against the
     fused sampler and against ``ChainTrackerOnDevice``.
Kernel launch counts are zeroed just before each main-path run and read
just after; comparison runs are not counted. Then a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": ...}``. Any failure exits non-zero
before the last line; without CUDA it exits 2. Needs one card; imports
nothing of JAX.
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
CORR_C = 128
# (map dtype, target dtype): serving; the first iteration of every bf16 window
# (the frame-0 feature is sampled with f32 weights) and of every later chained
# window (features carried on the host in f32); f32
CORR_PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("float32", "float32")]
CORR_CASES = [("flagship", 256, 60, 128), ("ragged", 100, 32, 48), ("dense", 7680, 60, 128)]
# drift bounds of a served window against the same model with a plain part
# (one iteration: bf16 rounding; six: bounded chaos, docs/TESTING.md)
ONE_ITER = dict(traj_max=1.0, vis_max=0.25)
SIX_ITERS = dict(median=2.0, p90=8.0, vis_median=0.5)
EXACT_PX = 1e-3  # runs that should agree exactly: same shapes, same kernels


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bf16_tol(ref_absmax: float) -> float:
    """Two bf16 ulps at the output's largest magnitude: the plain version
    rounds the fc1/fc2 products to bf16 before the f32 bias (as the JAX
    reference does), the kernel keeps them in f32; both round y once."""
    return 2.0 ** (math.ceil(math.log2(ref_absmax)) - 7)


def median_ms(torch, fn, args, launches: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``launches`` calls in a
    row, divided by ``launches``. A sleep kernel first holds the stream while
    the host queues them, so a call faster than its own host overhead (the
    corr kernel at small N) is timed on the device, not on the host."""
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device clock
        e0.record()
        for _ in range(launches):
            fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
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


def corr_args(torch, np, N: int, H8: int, W8: int, map_dt: str, tgt_dt: str, seed: int):
    """A 4-level pyramid of random (1, 8, H8, W8, 128) maps built by the port,
    targets, and coords uniform over the map and 4 px beyond every side."""
    from pips_tpu_torch.ops.corr import build_fmap_pyramid

    rng = np.random.RandomState(seed)
    fm = torch.from_numpy(rng.randn(1, 8, H8, W8, CORR_C).astype(np.float32))
    pyramid = [p.contiguous() for p in
               build_fmap_pyramid(fm.to("cuda", getattr(torch, map_dt)), 4)]
    targets = torch.from_numpy(rng.randn(1, 8, N, CORR_C).astype(np.float32))
    coords = np.stack([rng.uniform(-4, W8 + 3, (1, 8, N)), rng.uniform(-4, H8 + 3, (1, 8, N))],
                      axis=-1).astype(np.float32)
    return [pyramid, targets.to("cuda", getattr(torch, tgt_dt)),
            torch.from_numpy(coords).cuda()]


def corr_bound(torch, pyramid, targets, coords, radius: int = 3):
    """Least time for this call: its output, targets and coords once, and each
    map pixel that some in-bounds patch tap touches once (what these coords
    need), at the HBM rate; or 2*C operations per in-bounds tap at the
    inputs' peak (bf16 when maps and targets are bf16, else f32)."""
    from pips_tpu_torch.ops.corr import integer_patch_index

    B, S, N, C = targets.shape
    L = len(pyramid)
    nbytes = B * S * N * L * (2 * radius + 1) ** 2 * 4 + targets.numel() * targets.element_size()
    nbytes += coords.numel() * 4
    taps = 0
    for lvl, fm in enumerate(pyramid):
        H, W = fm.shape[2], fm.shape[3]
        idx, valid, _, _ = integer_patch_index(coords / (2.0 ** lvl), H, W, radius)
        frame = torch.arange(B * S, device=fm.device)[:, None] * (H * W)
        pixel = (frame + idx.reshape(B * S, -1))[valid.reshape(B * S, -1)]
        touched = torch.zeros(B * S * H * W, dtype=torch.bool, device=fm.device)
        touched[pixel] = True
        nbytes += int(touched.sum()) * C * fm.element_size()
        taps += pixel.numel()
    both_bf16 = pyramid[0].dtype == targets.dtype == torch.bfloat16
    t_ops = 2.0 * taps * C / PEAK_FLOPS["bfloat16" if both_bf16 else "float32"]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), nbytes


def corr_tol(corr_cuda, pyramid, targets, coords):
    """Elementwise bound on |kernel - plain|. Each side sums the same C f32
    products (exact for bf16 operands) in its own order, scales once and
    combines four taps with non-negative weights, so each is within
    gamma_(C+8) = (C+8) 2^-24 of the same sum of absolute values, which is the
    plain version run on |maps| and |targets|. Their difference is within
    twice that (zero where every tap is outside the map)."""
    C = targets.shape[-1]
    absref = corr_cuda.corr_sample_reference([p.abs() for p in pyramid], targets.abs(), coords)
    return 2.0 * (C + 8) * 2.0 ** -24 * absref


@contextlib.contextmanager
def plain_channel_blocks(mixer_module, reference):
    """Run the model's channel blocks through the plain version."""
    kernel = mixer_module.chan_ff_block
    mixer_module.chan_ff_block = reference
    try:
        yield
    finally:
        mixer_module.chan_ff_block = kernel


def drift(np, a_trajs, a_vis, b_trajs, b_vis) -> dict:
    d, v = np.abs(a_trajs - b_trajs), np.abs(a_vis - b_vis)
    return dict(max=float(d.max()), median=float(np.median(d)),
                p90=float(np.percentile(d, 90)), vis_max=float(v.max()),
                vis_median=float(np.median(v)))


def fmt(d: dict) -> str:
    return (f"traj median {d['median']:.3g} px, p90 {d['p90']:.3g}, max {d['max']:.3g}; "
            f"vis median {d['vis_median']:.3g}, max {d['vis_max']:.3g}")


def check_window(np, name, trajs, vis, xys, S: int = 8) -> None:
    N = xys.shape[1]
    if trajs.shape != (1, S, N, 2) or vis.shape != (1, S, N):
        fail(f"{name}: shapes {trajs.shape}, {vis.shape}")
    if not (np.isfinite(trajs).all() and np.isfinite(vis).all()):
        fail(f"{name}: non-finite output")
    if not np.array_equal(trajs[:, 0], xys):
        fail(f"{name}: frame 0 is not locked at the queries")


def check_drift(name: str, one: dict, six: dict) -> None:
    if not (one["max"] < ONE_ITER["traj_max"] and one["vis_max"] < ONE_ITER["vis_max"]):
        fail(f"{name}: one iteration differs beyond {ONE_ITER}: {one}")
    if not (six["median"] < SIX_ITERS["median"] and six["p90"] < SIX_ITERS["p90"]
            and six["vis_median"] < SIX_ITERS["vis_median"]):
        fail(f"{name}: six iterations drift beyond {SIX_ITERS}: {six}")


def window_seconds(torch, tracker, xys, rgbs) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    tracker(xys, rgbs)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    import numpy as np

    from pips_tpu_torch import (ChainTracker, ChainTrackerOnDevice, WindowTracker,
                                dense_queries, grid_queries, make_pips)
    from pips_tpu_torch.kernels import _build, corr_cuda, mixer_cuda
    from pips_tpu_torch.models import mixer as mixer_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def zero_counts():
        mixer_cuda.launches = 0
        corr_cuda.launches = 0

    def counts():
        return mixer_cuda.launches, corr_cuda.launches

    main_path = {"chan_ff_block": 0, "corr_sample": 0}  # launches summed over main-path runs

    def add_main(chanff_n, corr_n):
        main_path["chan_ff_block"] += chanff_n
        main_path["corr_sample"] += corr_n

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

    # 3a. chan_ff_block against its plain version, at the main path's shapes
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

    # 3b. corr_sample against its plain version: the flagship's level 0 at
    # 480x1024 is 60x128 (N=256, and the dense probe's N=7680); 32x48 with
    # N=100 has odd level sizes and a ragged last block of warps
    corr = {}
    for case, N, H8, W8 in CORR_CASES:
        for map_dt, tgt_dt in CORR_PAIRS:
            args = corr_args(torch, np, N, H8, W8, map_dt, tgt_dt, seed=N + H8)
            out = corr_cuda.corr_sample(*args)
            torch.cuda.synchronize()
            ref = corr_cuda.corr_sample_reference(*args)
            tol = corr_tol(corr_cuda, *args)
            diff = (out - ref).abs()
            err, ratio = diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()
            ms = median_ms(torch, corr_cuda.corr_sample, args)
            plain_ms = median_ms(torch, corr_cuda.corr_sample_reference, args, launches=3)
            bound_ms, bound_by, nbytes = corr_bound(torch, *args)
            log("kernels", f"corr_sample {case} N={N} {H8}x{W8} maps {map_dt}, targets {tgt_dt}: "
                           f"max_abs_err {err:.3g} (|out| <= {ref.abs().max().item():.3g}; "
                           f"elementwise tol up to {tol.max().item():.3g}, worst err/tol "
                           f"{ratio:.3g}); {ms:.4f} ms, plain (no yardstick) {plain_ms:.4f} ms, "
                           f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.2f} MB)")
            if not (out.shape == ref.shape and out.dtype == torch.float32 and ratio <= 1.0):
                fail(f"corr_sample {case} {map_dt}/{tgt_dt} disagrees with its plain version")
            corr[(case, map_dt, tgt_dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                bound_ms=bound_ms, bound_by=bound_by)
            del args, out, ref, tol, diff
    torch.cuda.empty_cache()

    # 4. slice: the served windows, onehot
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

    zero_counts()  # counts from here to the end of this path only
    served = []
    for name, rgbs, xys in requests:
        before = mixer_cuda.launches
        trajs, vis = tracker(xys, rgbs)
        n_launch = mixer_cuda.launches - before
        check_window(np, name, trajs, vis, xys)
        if n_launch != DEPTH * ITERS:
            fail(f"{name}: chan_ff_block launched {n_launch} times, expected {DEPTH * ITERS}")
        served.append((name, rgbs, xys, trajs, vis, n_launch))
    launches, corr_in_onehot = counts()
    if corr_in_onehot:
        fail(f"the onehot path launched the corr kernel {corr_in_onehot} times")
    add_main(launches, 0)

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
        one, six = drift(np, *k1, *p1), drift(np, trajs, vis, *p6)
        moved = np.abs(trajs - xys[:, None]).max()
        log("slice", f"{name}: {n_launch} launches; moved up to {moved:.1f} px; vs plain block: "
                     f"1 iter traj max {one['max']:.3g} px, vis max {one['vis_max']:.3g}; "
                     f"6 iters {fmt(six)}")
        check_drift(name, one, six)

    # 5. slice: the served windows, pallas (the corr kernel), and the dense probe
    requests.append(("dense_queries(480, 1024) N=7680 @480x1024",
                     rng.rand(1, 8, H, W, 3).astype(np.float32) * 255,
                     dense_queries(H, W).astype(np.float32)))
    tracker_p = WindowTracker(model, iters=ITERS, corr_mode="pallas")
    zero_counts()
    served_p = []
    for name, rgbs, xys in requests:
        before = counts()
        trajs, vis = tracker_p(xys, rgbs)
        n_ff, n_corr = (a - b for a, b in zip(counts(), before))
        check_window(np, name, trajs, vis, xys)
        if n_ff != DEPTH * ITERS or n_corr != ITERS:
            fail(f"{name}: pallas window launched chan_ff_block {n_ff} and corr_sample {n_corr} "
                 f"times, expected {DEPTH * ITERS} and {ITERS}")
        served_p.append((name, rgbs, xys, trajs, vis, n_ff, n_corr))
    add_main(*counts())

    # against the fused sampler, the corr kernel's plain version (the channel
    # block stays the kernel in both): the same drift bounds as above
    tracker_f1 = WindowTracker(model, iters=1, corr_mode="fused")
    tracker_p1 = WindowTracker(model, iters=1, corr_mode="pallas")
    tracker_f = WindowTracker(model, iters=ITERS, corr_mode="fused")
    pallas_vs_fused = {}
    for name, rgbs, xys, trajs, vis, n_ff, n_corr in served_p:
        one = drift(np, *tracker_p1(xys, rgbs), *tracker_f1(xys, rgbs))
        six = drift(np, trajs, vis, *tracker_f(xys, rgbs))
        log("slice", f"pallas {name}: {n_corr} corr + {n_ff} chan_ff launches; vs fused: "
                     f"1 iter traj max {one['max']:.3g} px, vis max {one['vis_max']:.3g}; "
                     f"6 iters {fmt(six)}")
        check_drift(f"pallas {name}", one, six)
        pallas_vs_fused[name] = dict(one=one, six=six)
    torch.cuda.empty_cache()

    # window times, onehot and pallas in turns (host clock, frames uploaded each call)
    window_ms = {}
    for idx in (0, len(requests) - 1):
        name, rgbs, xys = requests[idx]
        times = {"onehot": [], "pallas": []}
        for _ in range(7):
            times["onehot"].append(window_seconds(torch, tracker, xys, rgbs))
            times["pallas"].append(window_seconds(torch, tracker_p, xys, rgbs))
        N = xys.shape[1]
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        window_ms[name] = {k: v * 1e3 for k, v in med.items()}
        log("slice", f"{name}: median window over 7, in turns: onehot {med['onehot'] * 1e3:.2f} ms "
                     f"({N * 8 / med['onehot']:.0f} points*frames/s), pallas "
                     f"{med['pallas'] * 1e3:.2f} ms ({N * 8 / med['pallas']:.0f} points*frames/s) "
                     f"(host clock, frames uploaded each call)")
    torch.cuda.empty_cache()

    # 6. slice: a chained video through the host scheduler and on the device
    T, Hc, Wc = 32, 360, 640
    video = (np.random.RandomState(1).rand(T, Hc, Wc, 3) * 255).astype(np.float32)
    qs = grid_queries(Hc, Wc)[0]  # (256, 2)
    Nc = qs.shape[0]
    chain = ChainTracker(model, iters=ITERS, corr_mode="pallas", capacity=256)
    calls = [0]
    track = chain.tracker.track

    def counted_track(*a, **k):
        calls[0] += 1
        return track(*a, **k)

    chain.tracker.track = counted_track

    def chain_run(label, fn, *a):
        calls[0] = 0
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        trajs, vis = fn(*a)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        n_ff, n_corr = counts()
        if trajs.shape != (T, Nc, 2) or vis.shape != (T, Nc):
            fail(f"{label}: shapes {trajs.shape}, {vis.shape}")
        if not (np.isfinite(trajs).all() and np.isfinite(vis).all()):
            fail(f"{label}: non-finite output")
        if not (np.array_equal(trajs[0], qs) and vis.min() >= 0.0 and vis.max() <= 1.0):
            fail(f"{label}: frame 0 not at the queries, or vis outside [0, 1]")
        return trajs, vis, secs, n_ff, n_corr

    ct, cv, secs, n_ff, n_corr = chain_run("track_video", chain.track_video, video, qs)
    n_calls = calls[0]
    if n_corr != ITERS * n_calls or n_ff != DEPTH * ITERS * n_calls:
        fail(f"track_video: {n_calls} tracker calls launched corr_sample {n_corr} and "
             f"chan_ff_block {n_ff} times, expected {ITERS * n_calls} and {DEPTH * ITERS * n_calls}")
    add_main(n_ff, n_corr)
    log("chain", f"track_video T={T} {Hc}x{Wc} N={Nc}: {n_calls} tracker calls, {n_corr} corr + "
                 f"{n_ff} chan_ff launches; {secs:.3f} s wall, {T * Nc / secs:.0f} points*frames/s")
    chain_s = secs

    st, sv, secs, n_ff, n_corr = chain_run("track_stream", chain.track_stream,
                                           (f for f in video), qs)
    add_main(n_ff, n_corr)
    d_stream = float(np.abs(st - ct).max())
    log("chain", f"track_stream over a generator: {calls[0]} tracker calls, {secs:.3f} s; "
                 f"max |stream - video| {d_stream:.3g} px, vis {np.abs(sv - cv).max():.3g}; "
                 f"peak feature chunks held {chain.stream_peak_chunks} of {T // 8}")
    if d_stream > EXACT_PX:
        fail(f"track_stream differs from track_video by {d_stream} px > {EXACT_PX}")

    def skip4(vis, S):
        return np.full(vis.shape[0], 4, np.int64)

    chain.select_fn = skip4
    ft, fv, _, _, _ = chain_run("track_video skip 4, pallas", chain.track_video, video, qs)
    fused_chain = ChainTracker(model, iters=ITERS, corr_mode="fused", capacity=256,
                               select_fn=skip4)
    gt, gv, _, _, _ = chain_run("track_video skip 4, fused", fused_chain.track_video, video, qs)
    d_fused = drift(np, ft, fv, gt, gv)
    log("chain", f"skip 4, pallas vs fused: {fmt(d_fused)}")
    if not (d_fused["median"] < SIX_ITERS["median"] and d_fused["p90"] < SIX_ITERS["p90"]
            and d_fused["vis_median"] < SIX_ITERS["vis_median"]):
        fail(f"chained pallas drifts from fused beyond {SIX_ITERS}: {d_fused}")

    on_dev = ChainTrackerOnDevice(model, iters=ITERS, corr_mode="pallas", fixed_skip=4)
    dt, dv, secs, n_ff, n_corr = chain_run("ChainTrackerOnDevice", on_dev.track_video, video, qs)
    starts = -(-T // 4)
    if n_corr != ITERS * starts or n_ff != DEPTH * ITERS * starts:
        fail(f"ChainTrackerOnDevice: {starts} starts launched corr_sample {n_corr} and "
             f"chan_ff_block {n_ff} times")
    add_main(n_ff, n_corr)
    d_dev = drift(np, dt, dv, ft, fv)
    log("chain", f"ChainTrackerOnDevice skip 4: {starts} starts, {n_corr} corr + {n_ff} chan_ff "
                 f"launches, {secs:.3f} s; vs host tracker: {fmt(d_dev)}")
    if d_dev["max"] > EXACT_PX or d_dev["vis_max"] > EXACT_PX:
        fail(f"ChainTrackerOnDevice differs from the host tracker beyond {EXACT_PX}: {d_dev}")

    log("slice", f"main-path launches: {main_path}")
    main_ff = chanff[("bfloat16", R_MAIN)]
    main_corr = corr[("flagship", "bfloat16", "bfloat16")]
    print(json.dumps({"kernels": [
        {"name": "chan_ff_block", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_fwd.cu",
         "replaces": "pips_tpu/kernels/mixer_pallas.py:216",
         "launches": main_path["chan_ff_block"], **main_ff, "library_ms": None},
        {"name": "corr_sample", "route": "cuda",
         "source": "pips_tpu_torch/csrc/corr_sample_fwd.cu",
         "replaces": "pips_tpu/kernels/corr_pallas.py:185",
         "launches": main_path["corr_sample"], **main_corr, "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s "
                f"(chained video {chain_s:.2f} s; windows {json.dumps(window_ms)})")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
