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
     sampler, three point counts by three dtype pairs); and ``chan_ff_bwd``
     (the channel block's backward, bf16, at the train shapes R=1024, 24,576
     and 800), all seven grads;
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
     fused sampler and against ``ChainTrackerOnDevice``;
  7. slice, training: the same full-width bf16 model trains on synthetic
     batches through ``pips_tpu_torch.train``: (a) one step's loss and grads
     at the bench train shape (B=1, N=128, I=6, 384x512) against the plain
     channel block (forward and backward); (b) 20 steps on that fixed batch
     under ``make_optimizer(lr=5e-4, num_steps=20)``, finite, with the loss
     falling; (c) 3 timed steps at the training default (B=1 with both flips,
     so 4; N=768, I=4, 368x496): step ms, points*frames/s, peak memory, and
     12*I forward and backward channel-block launches per step.
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
GRAD_NAMES = ("dx", "d ln_scale", "d ln_bias", "dw1", "db1", "dw2", "db2")
# training: the bench train shape (bench.py: B=1, N=128, I=6, 384x512, no flips)
# and the training default (4hv_8_768_I4: B=1 doubled twice, N=768, I=4, 368x496)
TRAIN = dict(B=1, N=128, iters=6, H=384, W=512, flips=(False, False))
TRAIN_DEFAULT = dict(B=1, N=768, iters=4, H=368, W=496, flips=(True, True))
TRAIN_R = 1 * 128 * 8
TRAIN_R_DEFAULT = 4 * 768 * 8
TRAIN_RUN_STEPS = 20
# one step with the kernels against one with the plain channel block (forward
# and backward): the kernels keep the fc1/fc2 products in f32 where the plain
# forward rounds them to bf16, and six bf16 iterations carry that through
# floor(); the gather's backward adds in no fixed order. Loss relative error;
# cosine of all grads together, of the worst encoder leaf and of the worst
# other leaf (zero-gradient biases left out). First card run: 0.00375,
# 0.99962, 0.99957, 0.99504.
PARITY = dict(loss_rel=0.02, global_cos=0.995, encoder_cos=0.99, mixer_cos=0.98)


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


def chanff_bwd_args(torch, np, R: int, seed: int, D: int = 512, F: int = 2048):
    """x, dy, ln_scale, ln_bias, w1, b1, w2 for chan_ff_bwd, bf16 where the
    kernel takes the compute dtype."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(R, D), rng.randn(R, D), 1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D),
            rng.randn(D, F) / np.sqrt(D), 0.1 * rng.randn(F), rng.randn(F, D) / np.sqrt(F)]
    dts = [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
           torch.float32, torch.bfloat16]
    return [torch.from_numpy(v.astype(np.float32)).to("cuda", dt) for v, dt in zip(vals, dts)]


def chanff_bwd_bound(R: int, D: int = 512, F: int = 2048):
    """Least time for the backward: five products of 2RDF operations (a1
    recomputed, dg1, dxa, dw1, dw2) at the bf16 peak, or x, dy and dx once,
    both bf16 weights and the f32 vectors once, the f32 weight and vector
    grads once, at the HBM rate."""
    flops = 10.0 * R * D * F
    nbytes = 3 * R * D * 2 + 2 * D * F * 2 + 4 * (2 * D + F) + 2 * D * F * 4 + 4 * (3 * D + F)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chanff_bwd_tols(torch, mixer_cuda, args):
    """Elementwise bounds on |kernel - plain| for the seven grads. Each f32
    grad is a sum over rows of terms t_k (dw1: xa_c * da1_c; dw2: g1_c * dy;
    db1: da1; db2: dy; LN scale: dxa * xn; LN bias: dxa). The two sides sum
    in other orders (gamma_R = 2R 2^-24 of sum |t_k|), and where an f32 value
    sits at a bf16 rounding boundary the two round an operand one ulp apart
    (2^-7 of it). Such flips are sparse and of either sign, so their sum
    grows as the root of the sum of squares: 4 * 2^-7 * sqrt(sum t_k^2) holds
    four flips' worth on every term. dx is bf16: two ulps at its largest
    magnitude (``bf16_tol``)."""
    t = mixer_cuda.chan_ff_bwd_terms(*args)
    R = args[0].shape[0]
    flip, gamma = 4.0 * 2.0 ** -7, 2.0 * R * 2.0 ** -24

    def products(a, b):  # t_k = a[k, i] * b[k, j]
        return flip * torch.sqrt((a * a).t() @ (b * b)) + gamma * (a.abs().t() @ b.abs())

    def column(a):  # t_k = a[k, j]
        return flip * torch.sqrt((a * a).sum(0)) + gamma * a.abs().sum(0)

    dx_ref = mixer_cuda.chan_ff_bwd_reference(*args)[0]
    return [bf16_tol(dx_ref.float().abs().max().item()), column(t["dxa"] * t["xn"]),
            column(t["dxa"]), products(t["xa_c"], t["da1_c"]), column(t["da1"]),
            products(t["g1_c"], t["dy"]), column(t["dy"])]


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
        mixer_cuda.bwd_launches = 0
        corr_cuda.launches = 0

    def counts():
        return mixer_cuda.launches, corr_cuda.launches

    # launches summed over main-path runs
    main_path = {"chan_ff_block": 0, "corr_sample": 0, "chan_ff_bwd": 0}

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

    # 3c. chan_ff_bwd against its plain version: the bench train shape
    # (B*N*S = 1*128*8), the training default (4*768*8 after both flips) and
    # a ragged R that is no multiple of the kernel's 16-row blocks' tiles
    chanff_bwd = {}
    for R in (TRAIN_R, TRAIN_R_DEFAULT, 800):
        args = chanff_bwd_args(torch, np, R, seed=R)
        out = mixer_cuda.chan_ff_bwd(*args)
        torch.cuda.synchronize()
        ref = mixer_cuda.chan_ff_bwd_reference(*args)
        tols = chanff_bwd_tols(torch, mixer_cuda, args)
        worst, parts = 0.0, []
        for name, o, r, tol in zip(GRAD_NAMES, out, ref, tols):
            if o.shape != r.shape or o.dtype != r.dtype:
                fail(f"chan_ff_bwd R={R} {name}: {tuple(o.shape)} {o.dtype}, plain "
                     f"{tuple(r.shape)} {r.dtype}")
            diff = (o.float() - r.float()).abs()
            ratio = (diff / (tol.clamp_min(1e-30) if torch.is_tensor(tol) else tol)).max().item()
            worst = max(worst, ratio)
            parts.append(f"{name} {diff.max().item():.3g} (|g| <= {r.float().abs().max().item():.3g}, "
                         f"err/tol {ratio:.3g})")
        ms = median_ms(torch, mixer_cuda.chan_ff_bwd, args)
        plain_ms = median_ms(torch, mixer_cuda.chan_ff_bwd_reference, args)
        bound_ms, bound_by = chanff_bwd_bound(R)
        log("kernels", f"chan_ff_bwd bf16 R={R}: max_abs_err " + "; ".join(parts)
                       + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by})")
        if worst > 1.0:
            fail(f"chan_ff_bwd R={R} disagrees with its plain version (worst err/tol {worst:.3g})")
        chanff_bwd[R] = dict(max_abs_err=max((o.float() - r.float()).abs().max().item()
                                             for o, r in zip(out, ref)),
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del args, out, ref, tols
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

    # 7. slice: training through pips_tpu_torch.train
    from pips_tpu_torch.data import SyntheticPointDataset
    from pips_tpu_torch.train import (apply_flip_doubling, make_optimizer, make_train_step,
                                      train_loss_fn)

    torch.cuda.empty_cache()
    train_model = make_pips(device="cuda", seed=0, dtype=torch.bfloat16, fuse_chanff=True).train()

    def train_batch(cfg, seed):
        ds = SyntheticPointDataset(S=8, N=cfg["N"], H=cfg["H"], W=cfg["W"], seed=seed)
        samples = [ds[i][0] for i in range(cfg["B"])]
        return {k: torch.from_numpy(np.stack([x[k] for x in samples])).cuda()
                for k in samples[0]}

    def loss_and_grads(batch, cfg):
        train_model.zero_grad(set_to_none=True)
        total, metrics = train_loss_fn(train_model, apply_flip_doubling(batch, *cfg["flips"]),
                                       cfg["iters"])
        total.backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in metrics.items()},
                {n: p.grad.detach().float().clone() for n, p in train_model.named_parameters()})

    def train_counts():
        return mixer_cuda.launches, mixer_cuda.bwd_launches, corr_cuda.launches

    def zero_grad_leaf(name):  # biases that a following normalisation removes
        return ((name.startswith("fnet.") and name.endswith(".bias")
                 and not name.startswith("fnet.conv3.")) or
                (name.endswith("_token.fc2.bias")))

    batch = train_batch(TRAIN, seed=0)
    per_step = DEPTH * TRAIN["iters"]
    # (a) one step's loss and grads, kernels against the plain channel block
    zero_counts()
    k_metrics, k_grads = loss_and_grads(batch, TRAIN)
    n_fwd, n_bwd, n_corr = train_counts()
    if (n_fwd, n_bwd, n_corr) != (per_step, per_step, 0):
        fail(f"parity step launched chan_ff_block {n_fwd}, chan_ff_bwd {n_bwd} and corr_sample "
             f"{n_corr} times, expected {per_step}, {per_step} and 0")
    main_path["chan_ff_block"] += n_fwd
    main_path["chan_ff_bwd"] += n_bwd
    kernel_fwd, kernel_bwd = mixer_cuda._forward, mixer_cuda.chan_ff_bwd
    mixer_cuda._forward, mixer_cuda.chan_ff_bwd = (mixer_cuda.chan_ff_reference,
                                                   mixer_cuda.chan_ff_bwd_reference)
    try:
        zero_counts()
        p_metrics, p_grads = loss_and_grads(batch, TRAIN)
        if any(train_counts()):
            fail(f"the plain channel block launched kernels: {train_counts()}")
    finally:
        mixer_cuda._forward, mixer_cuda.chan_ff_bwd = kernel_fwd, kernel_bwd
    loss_rel = abs(k_metrics["total_loss"] - p_metrics["total_loss"]) / abs(p_metrics["total_loss"])
    cos_of = {}  # in f64: ~29M terms
    for name, g in k_grads.items():
        if zero_grad_leaf(name):
            continue
        g, p = g.double(), p_grads[name].double()
        cos_of[name] = (torch.dot(g.ravel(), p.ravel()) / (g.norm() * p.norm())).item()
    flat_k = torch.cat([g.ravel().double() for n, g in k_grads.items() if n in cos_of])
    flat_p = torch.cat([p_grads[n].ravel().double() for n in cos_of])
    global_cos = (torch.dot(flat_k, flat_p) / (flat_k.norm() * flat_p.norm())).item()
    global_rel = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    enc = {n: c for n, c in cos_of.items() if n.startswith("fnet.")}
    mix = {n: c for n, c in cos_of.items() if not n.startswith("fnet.")}
    worst_enc, worst_mix = min(enc, key=enc.get), min(mix, key=mix.get)
    log("train", f"parity step (B=1 N=128 I=6 384x512): loss {k_metrics['total_loss']:.5g} "
                 f"(seq {k_metrics['seq']:.4g}, vis {k_metrics['vis']:.4g}, ce {k_metrics['ce']:.4g}) "
                 f"vs plain {p_metrics['total_loss']:.5g}, rel {loss_rel:.3g}; grads: global cos "
                 f"{global_cos:.6f}, rel L2 {global_rel:.3g}; worst leaf cos {enc[worst_enc]:.5f} "
                 f"({worst_enc}), outside the encoder {mix[worst_mix]:.5f} ({worst_mix}); "
                 f"{n_fwd} + {n_bwd} launches")
    if not (loss_rel <= PARITY["loss_rel"] and global_cos >= PARITY["global_cos"]
            and enc[worst_enc] >= PARITY["encoder_cos"]
            and mix[worst_mix] >= PARITY["mixer_cos"]):
        fail(f"training with the kernels differs from the plain channel block beyond {PARITY}")
    del k_grads, p_grads, flat_k, flat_p
    train_model.zero_grad(set_to_none=True)

    # (b) 20 steps on the fixed batch
    opt = make_optimizer(train_model.parameters(), lr=5e-4, num_steps=TRAIN_RUN_STEPS)
    step = make_train_step(train_model, opt, iters=TRAIN["iters"], horz_flip=False,
                           vert_flip=False)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run = [step(batch) for _ in range(TRAIN_RUN_STEPS)]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    n_fwd, n_bwd, n_corr = train_counts()
    if (n_fwd, n_bwd, n_corr) != (per_step * TRAIN_RUN_STEPS, per_step * TRAIN_RUN_STEPS, 0):
        fail(f"the 20-step run launched chan_ff_block {n_fwd}, chan_ff_bwd {n_bwd}, corr_sample "
             f"{n_corr} times")
    main_path["chan_ff_block"] += n_fwd
    main_path["chan_ff_bwd"] += n_bwd
    losses = [m["total_loss"] for m in run]
    log("train", f"{TRAIN_RUN_STEPS} steps on one batch (lr 5e-4, onecycle over "
                 f"{TRAIN_RUN_STEPS + 100}): total_loss {' '.join(f'{x:.4g}' for x in losses)}; "
                 f"ate_all {run[0]['ate_all']:.3g} -> {run[-1]['ate_all']:.3g} px; "
                 f"{run_s / TRAIN_RUN_STEPS * 1e3:.1f} ms/step (host clock)")
    if not all(math.isfinite(v) for m in run for v in m.values()):
        fail("non-finite metrics in the 20-step run")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over {TRAIN_RUN_STEPS} steps: {losses[0]} -> {losses[-1]}")
    del opt, step, batch
    torch.cuda.empty_cache()

    # (c) timed steps at the training default
    big = train_batch(TRAIN_DEFAULT, seed=1)
    opt = make_optimizer(train_model.parameters(), lr=5e-4, num_steps=100)
    step = make_train_step(train_model, opt, iters=TRAIN_DEFAULT["iters"], horz_flip=True,
                           vert_flip=True)
    per_step = DEPTH * TRAIN_DEFAULT["iters"]
    zero_counts()
    step(big)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(3):
        before = train_counts()
        t = time.perf_counter()
        m = step(big)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        n_fwd, n_bwd, n_corr = (a - b for a, b in zip(train_counts(), before))
        if (n_fwd, n_bwd, n_corr) != (per_step, per_step, 0):
            fail(f"a default train step launched chan_ff_block {n_fwd}, chan_ff_bwd {n_bwd}, "
                 f"corr_sample {n_corr} times, expected {per_step}, {per_step}, 0")
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"non-finite metrics at the training default: {m}")
    n_fwd, n_bwd, _ = train_counts()
    main_path["chan_ff_block"] += n_fwd
    main_path["chan_ff_bwd"] += n_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med_s = sorted(step_s)[1]
    pf = 4 * TRAIN_DEFAULT["N"] * 8 / med_s
    train_default = dict(step_ms=med_s * 1e3, points_frames_per_s=pf, peak_gb=peak_gb)
    log("train", f"training default (B=1 x4 flips, N=768, I=4, 368x496): steps "
                 f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, median {med_s * 1e3:.1f} ms; "
                 f"{pf:.0f} points*frames/s (4 x 768 x 8 per step); peak memory {peak_gb:.2f} GB; "
                 f"{per_step} chan_ff_block + {per_step} chan_ff_bwd launches per step; "
                 f"total_loss {m['total_loss']:.4g}")

    log("slice", f"main-path launches: {main_path}")
    if min(main_path.values()) == 0:
        fail(f"a kernel of the path never launched on it: {main_path}")
    main_ff = chanff[("bfloat16", R_MAIN)]
    main_corr = corr[("flagship", "bfloat16", "bfloat16")]
    print(json.dumps({"kernels": [
        {"name": "chan_ff_block", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_fwd.cu",
         "replaces": "pips_tpu/kernels/mixer_pallas.py:216",
         "launches": main_path["chan_ff_block"], **main_ff, "library_ms": None},
        {"name": "corr_sample", "route": "cuda",
         "source": "pips_tpu_torch/csrc/corr_sample_fwd.cu",
         "replaces": "pips_tpu/kernels/corr_pallas.py:185",
         "launches": main_path["corr_sample"], **main_corr, "library_ms": None},
        {"name": "chan_ff_bwd", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_bwd.cu",
         "replaces": "pips_tpu/kernels/mixer_pallas.py:245",
         "launches": main_path["chan_ff_bwd"], **chanff_bwd[TRAIN_R_DEFAULT],
         "library_ms": None}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s "
                f"(chained video {chain_s:.2f} s; windows {json.dumps(window_ms)}; "
                f"training default {json.dumps(train_default)})")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
