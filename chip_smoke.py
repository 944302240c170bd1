#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pips_tpu_torch``): the quickest
proof that the port still starts, builds its kernels and serves on a GPU.

    python3 chip_smoke.py

Phases, each printing a progress line with the elapsed seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel under pips_tpu_torch/csrc, with nvcc, timed;
  3. kernels: each kernel against its plain PyTorch version at the main
     paths' shapes, with its tolerance, median time and bound:
     ``chan_ff_block`` (fused channel block, bf16 and f32 at the windows'
     R=2048 and 2000, f32 also at the f32 train path's R=1024 and 24,576) and
     ``corr_sample`` (fused corr sampler, three point counts by three dtype
     pairs); and ``chan_ff_bwd``
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
     12*I forward and backward channel-block launches per step;
  8. slice, the train loop: ``pips_tpu_torch.train.loop.train(cfg, "cuda")``
     with ``fuse_conv3=1`` at full width on the synthetic set at the bench
     train shape, 12 steps with validation, media and a checkpoint every 6,
     through the CUDA prefetcher; the loss must be finite and fall, the last
     step's checkpoint exist, ``events.jsonl`` hold pooled and val_pooled
     keys, and a relaunch with more steps resume at the saved step; conv
     kernel launches: 8 per train step, 4 per validation batch and media
     render;
  7d. slice, f32 training with fused channel blocks (the f32 backward
     kernel's path): the full-width model with ``dtype=None``, (a) one step
     at the bench train shape against the plain channel block, with one
     refinement iteration (loss within 0.1%, every leaf's grad cosine at
     least 0.999) and with six (phase 7a's bounds; beside it, printed, the
     plain block summed in F chunks against the plain block, the reading of
     what summation order alone does at six); (b) the loop's own entry
     point, ``train.loop.main`` with ``--dtype float32 --fuse_chanff 1``, 12
     steps with a validation pass and a checkpoint, the loss finite and
     falling; (c) 2 timed steps at the training default; 12*I forward and
     12*I f32 backward launches per step;
  9. slice, the profiling tools: ``pips_tpu_torch.tools.profile_block_kernel``,
     ``profile_stem_wgrad`` and ``profile_chanff_chunk``'s ``main`` at their
     full-width shapes (the stage-1 residual block at 8x64x192x256 bf16; the
     stem weight gradient at B=1 and B=8, 384x512 bf16; a chain of 12 channel
     blocks at R=1024, chunk widths 512 and 1024); ``res_block64`` must
     launch the conv-pass kernel 2 times per forward and 4 per
     forward+backward, ``stem_wgrad`` its kernel once per weight gradient,
     and the chunked chain 12 forward launches per chain forward and 12
     backward launches per chain backward.
Phase 3 also holds (3d) ``conv3x3_same`` (the encoder's stage-1 3x3 conv)
against its plain version, forward and dx, at a window's, the training
default's and the bench train shape's stage 1 in bf16 and a small ragged
shape in bf16 and f32, all channels_last, with dW and db through its autograd Function, timed in turns with
``F.conv2d``; and phase 4 (4b) serves the N=256 window with ``fuse_conv3``
against the same weights without it, 4 conv launches per window. 3e holds
``conv_pass`` (the residual block's conv with the norm statistics in its
epilogue), with and without its prologue, against its plain version at the
block's bench shape in bf16 and a ragged f32 shape, and the whole
``res_block64``, forward and five grads, against ``res_block64_reference``;
timed in turns with ``F.conv2d`` and the modular ``ResidualBlock``. 3f holds
``stem_wgrad`` against its plain version at B=1 and B=8, 384x512 bf16 and a
small f32 shape, timed in turns with the library's weight grad of the s2d
conv and of the x7 conv. 3g holds ``chan_ff_bwd`` in f32 (the f32 kernel) at
R=1024, 800 and 24,576 against its plain version, all seven grads, with
matmuls in full f32 (TF32 off). 3h holds the F-chunked channel block
(``chan_ff_block_chunked`` and ``chan_ff_chunked_bwd``) at R=1024 and 800,
bf16, against its plain versions at every chunk width the kernels take (128,
256, 512, 1024); at the tool's 512 and 1024 also timed in turns with the
monolithic kernels; and in f32 at every one of those widths (the f32 chunked
block is the f32 monolithic block, so it launches ``chanff_fwd.cu``'s and
``chanff_bwd.cu``'s f32 kernels), with 3g's f32 bounds and TF32 off. 3i holds
the Mosaic probe kernels of the three probe tools against their plain
versions at the tools' shapes, each timed beside its bound and one library
call where there is one: ``gelu``, ``ln_slice`` and ``stream_accum``
(``tools/debug_mixer_kernel.py``, x (128, 4096) and w1 (12, 512, 2048)
bf16), ``corr_rows`` (``tools/debug_pallas7.py``, 8 points on a 16x128 map
of 128 f32 channels) and ``row_contract`` in the four layouts of
``tools/probe_mosaic_ops.py`` ((24, 256, 6) x (24, 256, 64) bf16). Phase 9
then runs the ports of those three tools, the probe kernels' paths, each
probe's kernel launched 2 + 5 * 10 times.
Kernel launch counts are zeroed just before each main-path run and read
just after; comparison runs are not counted. Then a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": ...}``. Any failure exits non-zero
before the last line; without CUDA it exits 2. Needs one card; imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# the encoder's stage-1 input (B*S, 64, H/2, W/2) of a 480x1024 window, of
# the training default (4 flips x 8 frames at 368x496) and of the bench train
# shape (8 frames at 384x512); and a small shape with ragged tiles in bf16 and
# f32. All channels_last, as the encoder holds them and the kernel reads them.
CONV_SHAPES = [("window", 8, 240, 512, "bfloat16"),
               ("train default", 32, 184, 248, "bfloat16"),
               ("bench train", 8, 192, 256, "bfloat16"),
               ("small", 2, 31, 70, "bfloat16"),
               ("small f32", 2, 31, 70, "float32")]
CONV_PER_ENCODE = 4  # layer1_0.conv1/conv2 and layer1_1.conv1/conv2
LOOP_STEPS, LOOP_EVERY, LOOP_MORE = 12, 6, 6  # phase 8: steps, val/save/media period, relaunch
# phase 3e: the residual block's conv pass at the stage-1 bench shape of
# tools/profile_block_kernel.py (8 frames at 192x256, 64 channels, bf16) and a
# small shape with ragged tiles in f32; the whole block at the first
PASS_CASES = [("bench", 8, 192, 256, "bfloat16"), ("small f32", 2, 31, 70, "float32")]
# phase 3f: the stem weight gradient at tools/profile_stem_wgrad.py's shapes,
# and a small one in f32 whose rows end in a partial segment of columns
STEM_CASES = [("B=1", 1, 384, 512, "bfloat16"), ("B=8", 8, 384, 512, "bfloat16"),
              ("small f32", 2, 64, 96, "float32")]
U32 = 2.0 ** -24  # unit roundoff of f32
CHUNK_FCS = (512, 1024)  # phase 3h times these: tools/profile_chanff_chunk.py's chunk widths
# phase 7d, f32 with fused channel blocks against the plain block: both keep
# f32 products and differ only in summation order. One refinement iteration
# is compared tightly: loss within 0.1%, every leaf's grad cosine (zero-
# gradient biases left out) at least 0.999 (first card run: 6.3e-8 and
# 1.0000000). Six iterate the corr lookups through floor(), which turns any
# difference into bounded chaos (docs/TESTING.md), so the bench shape's I=6
# step is held to PARITY, the bf16 step's bounds (first card run: 4.3e-4,
# global cosine 0.99986, worst leaf 0.9968)
PARITY_F32 = dict(loss_rel=1e-3, leaf_cos=0.999)
WITNESS_FC = 512  # 7d's witness at I=6: the plain block with fc2 and dxa summed in F chunks
# the kernels of a train step, as train_counts reads their launches
TRAIN_KERNELS = ("chan_ff_block", "chan_ff_bwd", "chan_ff_bwd_f32", "corr_sample")
# phase 7d: steps of train.loop.main, with one validation pass and a save at
# the last. Not 6: AdamW's warm-up raises the loss over the first 4-6 steps
# (phase 8's bf16 loop: 68, 78, 99, 117, 87, 73, then 70 ... 47 by step 12)
LOOP_F32_STEPS = 12
# the whole block against its plain version: the forward within four bf16
# ulps at its largest magnitude (both round y1, the pass-2 input, y2 and the
# output, from f32 values that differ in summation order); the grads of x, w1
# and w2 by the encoder-leaf rule of phase 7 (a relu mask can flip where two
# forwards differ by an ulp, which moves a grad at that pixel by its whole
# size), tightened; each db is rounding noise around zero (the norm removes
# the bias), held against the weight grads' scale
BLOCK_TOL = dict(grad_cos=0.999, grad_rel_l2=0.02, db_of_dw=0.01)


# the Mosaic probe kernels: kernels-line name, source, the pallas_call it replaces
PROBE_KERNELS = [("gelu", "mixer_probes", "tools/debug_mixer_kernel.py:63"),
                 ("ln_slice", "mixer_probes", "tools/debug_mixer_kernel.py:66"),
                 ("stream_accum", "mixer_probes", "tools/debug_mixer_kernel.py:69"),
                 ("corr_rows", "corr_rows", "tools/debug_pallas7.py:15"),
                 ("row_contract_a", "row_contract", "tools/probe_mosaic_ops.py:46"),
                 ("row_contract_a2", "row_contract", "tools/probe_mosaic_ops.py:67"),
                 ("row_contract_b", "row_contract", "tools/probe_mosaic_ops.py:89"),
                 ("row_contract_c", "row_contract", "tools/probe_mosaic_ops.py:110")]


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


def chanff_bwd_args(torch, np, R: int, seed: int, D: int = 512, F: int = 2048, dtype=None):
    """x, dy, ln_scale, ln_bias, w1, b1, w2 for chan_ff_bwd, in the compute
    dtype (bf16 unless given) where the kernel takes it."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(R, D), rng.randn(R, D), 1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D),
            rng.randn(D, F) / np.sqrt(D), 0.1 * rng.randn(F), rng.randn(F, D) / np.sqrt(F)]
    cd = dtype or torch.bfloat16
    dts = [cd, cd, torch.float32, torch.float32, cd, torch.float32, cd]
    return [torch.from_numpy(v.astype(np.float32)).to("cuda", dt) for v, dt in zip(vals, dts)]


def chanff_bwd_bound(R: int, dtype: str = "bfloat16", D: int = 512, F: int = 2048):
    """Least time for the backward: five products of 2RDF operations (a1
    recomputed, dg1, dxa, dw1, dw2) at the dtype's peak, or x, dy and dx once,
    both weights in the dtype and the f32 vectors once, the f32 weight and
    vector grads once, at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 10.0 * R * D * F
    nbytes = (3 * R * D * esize + 2 * D * F * esize + 4 * (2 * D + F) + 2 * D * F * 4
              + 4 * (3 * D + F))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
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
    magnitude (``bf16_tol``).

    In f32 no operand is rounded to a coarser type: each differs only by its
    own f32 sums (a1 and dg1 over D, dxa over F) taken in other orders, so the
    flip term's 2^-7 becomes (D + F) 2^-24. dx is f32 and held elementwise:
    the LN backward (|rsig| times |dxn|, its mean and |xn| times the mean of
    |dxn xn|) of dxa's bound, which is 2F 2^-24 of |da1| @ |w1|^T for the
    order plus the operand term, and 4D 2^-24 of each of the LN backward's
    terms for the statistics and means over D."""
    t = mixer_cuda.chan_ff_bwd_terms(*args)
    R = args[0].shape[0]
    D, F = args[4].shape
    f32 = args[0].dtype == torch.float32
    flip, gamma = 4.0 * ((D + F) * U32 if f32 else 2.0 ** -7), 2.0 * R * 2.0 ** -24

    def products(a, b):  # t_k = a[k, i] * b[k, j]
        return flip * torch.sqrt((a * a).t() @ (b * b)) + gamma * (a.abs().t() @ b.abs())

    def column(a):  # t_k = a[k, j]
        return flip * torch.sqrt((a * a).sum(0)) + gamma * a.abs().sum(0)

    if f32:
        w1, scale = args[4], args[2]
        e_dxa = (2 * F * U32 * (t["da1_c"].abs() @ w1.abs().t())
                 + flip * torch.sqrt((t["da1_c"] ** 2) @ (w1 ** 2).t()))
        e_n, xn = scale.abs() * e_dxa, t["xn"].abs()
        dxn = t["dxa"] * scale
        m1, m2 = dxn.mean(-1, keepdim=True), (dxn * t["xn"]).mean(-1, keepdim=True)
        ln_bwd = e_n + e_n.mean(-1, keepdim=True) + xn * (e_n * xn).mean(-1, keepdim=True)
        terms = t["dy"].abs() + t["rsig"] * (dxn.abs() + m1.abs() + xn * m2.abs())
        dx_tol = t["rsig"] * ln_bwd + 4 * D * U32 * terms
    else:
        dx_tol = bf16_tol(mixer_cuda.chan_ff_bwd_reference(*args)[0].float().abs().max().item())
    return [dx_tol, column(t["dxa"] * t["xn"]),
            column(t["dxa"]), products(t["xa_c"], t["da1_c"]), column(t["da1"]),
            products(t["g1_c"], t["dy"]), column(t["dy"])]


def grad_errors(torch, label: str, out, ref, tols):
    """The seven grads of a backward against its plain version: the worst
    err/tol, a printable part per grad and the largest abs error. Fails on a
    shape or dtype that differs."""
    worst, parts, errs = 0.0, [], []
    for name, o, r, tol in zip(GRAD_NAMES, out, ref, tols):
        if o.shape != r.shape or o.dtype != r.dtype:
            fail(f"{label} {name}: {tuple(o.shape)} {o.dtype}, plain {tuple(r.shape)} {r.dtype}")
        diff = (o.float() - r.float()).abs()
        ratio = (diff / (tol.clamp_min(1e-30) if torch.is_tensor(tol) else tol)).max().item()
        worst = max(worst, ratio)
        errs.append(diff.max().item())
        parts.append(f"{name} {errs[-1]:.3g} (|g| <= {r.float().abs().max().item():.3g}, "
                     f"err/tol {ratio:.3g})")
    return worst, parts, max(errs)


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


def conv_args(torch, np, B: int, H: int, W: int, dtype: str, seed: int, C: int = 64):
    """x (B, C, H, W) in dtype and channels_last, an f32 weight and bias as
    the encoder holds them, and dy for the backward."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(B, C, H, W), rng.randn(C, C, 3, 3) * np.sqrt(2.0 / (9 * C)),
            0.1 * rng.randn(C), rng.randn(B, C, H, W)]
    dts = [getattr(torch, dtype), torch.float32, torch.float32, getattr(torch, dtype)]
    x, w, b, dy = (torch.from_numpy(v.astype(np.float32)).to("cuda", dt)
                   for v, dt in zip(vals, dts))
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), w, b, dy.contiguous(memory_format=cl)


def conv_bound(B: int, H: int, W: int, dtype: str, C: int = 64, O: int = 64):
    """Least time for one conv: 2*9*C*O operations per output pixel at the
    dtype's peak, or x and y once, the weight once (in x's dtype) and the f32
    bias once at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * B * H * W * O * 9 * C
    nbytes = B * H * W * (C + O) * esize + 9 * C * O * esize + 4 * O
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def pass_args(torch, np, B: int, H: int, W: int, dtype: str, seed: int, C: int = 64):
    """x (B, C, H, W) channels_last in dtype, an f32 weight and bias as the
    encoder holds them, and a per-image [scale; shift] (B, 2, C) as the
    block's first norm gives it (scale = rsig > 0, shift of either sign)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to("cuda", getattr(torch, dtype))
    w = rng.randn(C, C, 3, 3) * np.sqrt(2.0 / (9 * C))
    aff = np.stack([0.5 + rng.rand(B, C), 0.3 * rng.randn(B, C)], axis=1)
    w, b, aff = (torch.from_numpy(v.astype(np.float32)).cuda()
                 for v in (w, 0.1 * rng.randn(C), aff))
    return x.permute(0, 3, 1, 2), w, b, aff


def pass_tols(torch, F, x, w, b, aff, prologue: bool, tiles: int):
    """Bounds on |kernel - plain| of a conv pass. Each side sums the same 576
    products of the pass's input (exact for bf16 operands) and the bias in
    f32 in its own order, so each accumulator is within gamma_577 = 577 u of
    the same sum of absolute values A (the conv of |input| with |w|, plus
    |b|): the two differ by at most twice that, elementwise. The plain
    statistics are summed in f64; the kernel's add at most tiles + 20
    accumulators in a chain (four per thread, three shuffle levels, four
    warps, then the tiles), each rounding within u of the running sum.
    Returns the accumulators' bound and the (B, 2, 64) bound of the stats."""
    xin = x.float()
    if prologue:
        scale, shift = aff[:, 0, :, None, None], aff[:, 1, :, None, None]
        xin = (xin * scale + shift).clamp_min(0.0).to(x.dtype).float()
    wk = w.to(x.dtype).float()
    acc = F.conv2d(xin, wk, b, padding=1)
    tol_acc = 2 * 577 * U32 * F.conv2d(xin.abs(), wk.abs(), b.abs(), padding=1)
    chain = (tiles + 20) * U32
    tol_s = tol_acc.sum(dim=(2, 3)) + chain * acc.abs().sum(dim=(2, 3))
    tol_q = ((2 * acc.abs() + tol_acc) * tol_acc).sum(dim=(2, 3)) + chain * (acc * acc).sum(
        dim=(2, 3))
    return tol_acc, torch.stack([tol_s, tol_q], dim=1)


def pass_bound(B: int, H: int, W: int, dtype: str, C: int = 64):
    """Least time for one conv pass: the conv's operations at the dtype's
    peak, or x and y once, the weight, the f32 bias and affine once and the
    (B, 2, C) f32 statistics once at the HBM rate."""
    esize = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * B * H * W * C * 9 * C
    nbytes = 2 * B * H * W * C * esize + 9 * C * C * esize + 4 * C + 2 * (4 * B * 2 * C)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def stem_args(torch, np, B: int, H: int, W: int, dtype: str, seed: int):
    """x2 (B, 6, 2*Ho + 6, Wo + 3) and dy (B, 64, Ho, Wo), uniform in
    [-0.5, 0.5) as tools/profile_stem_wgrad.py draws them, channels_last."""
    rng = np.random.RandomState(seed)
    Ho, Wo = H // 2, W // 2
    x2 = rng.rand(B, 2 * Ho + 6, Wo + 3, 6) - 0.5
    dy = rng.rand(B, Ho, Wo, 64) - 0.5
    return [torch.from_numpy(v.astype(np.float32)).to("cuda", getattr(torch, dtype))
            .permute(0, 3, 1, 2) for v in (x2, dy)]


def stem_bound(x2, dy, dtype: str, KY: int = 7, KX: int = 4):
    """Least time for the weight gradient: 2 * KY*KX*C * O operations per
    output pixel at the dtype's peak, or x2 and dy once and the f32 dk once
    at the HBM rate."""
    B, C = x2.shape[:2]
    O, Ho, Wo = dy.shape[1:]
    flops = 2.0 * KY * KX * C * O * B * Ho * Wo
    nbytes = (x2.numel() * x2.element_size() + dy.numel() * dy.element_size()
              + 4 * KY * KX * C * O)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cos_rel(torch, a, b):
    """Cosine and relative L2 distance of a against b, in f64."""
    a, b = a.double().ravel(), b.double().ravel()
    return (torch.dot(a, b) / (a.norm() * b.norm())).item(), ((a - b).norm() / b.norm()).item()


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


def phase_block(torch, np, F, block_cuda) -> dict:
    """3e: ``conv_pass`` against its plain version, with and without the
    prologue, then the whole ``res_block64`` forward and five grads against
    ``res_block64_reference``, with times in turns with the library."""
    from pips_tpu_torch.models.encoder import ResidualBlock

    out = {}
    _, tiles = block_cuda._kernel()
    for case, B, H, W, dtype in PASS_CASES:
        x, w, b, aff = pass_args(torch, np, B, H, W, dtype, seed=B + H)
        parts, errs = [], []
        for prologue in (False, True):
            y, st = block_cuda.conv_pass(x, w, b, aff, prologue)
            torch.cuda.synchronize()
            y_ref, st_ref = block_cuda.conv_pass_reference(x, w, b, aff, prologue)
            tol_acc, tol_st = pass_tols(torch, F, x, w, b, aff, prologue,
                                        tiles(H, W, 1 if dtype == "bfloat16" else 0))
            err = (y.float() - y_ref.float()).abs()
            if dtype == "bfloat16":
                y_ratio = err.max().item() / bf16_tol(y_ref.float().abs().max().item())
            else:
                y_ratio = (err / (tol_acc + U32 * y_ref.abs())).max().item()
            st_ratio = ((st - st_ref).abs() / tol_st).max().item()
            st_rel = ((st - st_ref).abs() / st_ref.abs().clamp_min(1e-30)).max().item()
            parts.append(f"prologue {prologue}: y max_abs_err {err.max().item():.3g} (err/tol "
                         f"{y_ratio:.3g}), stats max rel err {st_rel:.3g} (err/tol {st_ratio:.3g})")
            if not (y.shape == y_ref.shape and y.dtype == y_ref.dtype and st.shape == (B, 2, 64)
                    and y.is_contiguous(memory_format=torch.channels_last)
                    and y_ratio <= 1.0 and st_ratio <= 1.0):
                fail(f"conv_pass {case} prologue={prologue} disagrees with its plain version")
            errs.append(err.max().item())
        wk, bl = w.to(x.dtype), b.to(x.dtype)
        args = (x, wk, b, aff, True)  # the second pass of the block: prologue on

        def library():
            return F.conv2d(x, wk, bl, padding=1)

        k1 = median_ms(torch, block_cuda.conv_pass, args)
        l1 = median_ms(torch, library, ())
        k2 = median_ms(torch, block_cuda.conv_pass, args)
        l2 = median_ms(torch, library, ())
        k0 = median_ms(torch, block_cuda.conv_pass, (x, wk, b, aff, False))
        plain_ms = median_ms(torch, block_cuda.conv_pass_reference, args, launches=5)
        bound_ms, bound_by = pass_bound(B, H, W, dtype)
        log("kernels", f"conv_pass {case} {B}x64x{H}x{W} {dtype} channels_last: "
                       + "; ".join(parts) + f"; prologue on {k1:.4f}/{k2:.4f} ms, F.conv2d "
                       f"{l1:.4f}/{l2:.4f} ms (in turns), prologue off {k0:.4f} ms, plain "
                       f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out[case] = dict(max_abs_err=max(errs), ms=(k1 + k2) / 2, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=(l1 + l2) / 2)
        del x, w, b, aff, y, st, y_ref, st_ref, tol_acc, tol_st, err
    torch.cuda.empty_cache()

    # the whole block at the bench shape, forward and all five grads
    _, B, H, W, dtype = PASS_CASES[0]
    rng = np.random.RandomState(7)
    dt = getattr(torch, dtype)

    def cl(a):  # NHWC numpy -> (B, C, H, W) channels_last on the card
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt).permute(0, 3, 1, 2)

    x, dout = cl(rng.randn(B, H, W, 64)), cl(rng.randn(B, H, W, 64))
    params = [torch.from_numpy(v.astype(np.float32)).cuda() for v in
              (rng.randn(64, 64, 3, 3) * 0.06, 0.1 * rng.randn(64),
               rng.randn(64, 64, 3, 3) * 0.06, 0.1 * rng.randn(64))]
    runs = {}
    for side, fn in (("kernel", block_cuda.res_block64),
                     ("plain", block_cuda.res_block64_reference)):
        leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
        y = fn(*leaves)
        y.backward(dout)
        torch.cuda.synchronize()
        runs[side] = (y.detach(), [t.grad for t in leaves])
    (y, grads), (y_ref, grads_ref) = runs["kernel"], runs["plain"]
    err = (y.float() - y_ref.float()).abs().max().item()
    tol = 2 * bf16_tol(y_ref.float().abs().max().item())
    parts = [f"out {err:.3g} (tol {tol:.3g})"]
    ok = y.shape == y_ref.shape and y.dtype == y_ref.dtype and err <= tol
    dw_max = max(grads_ref[1].abs().max().item(), grads_ref[3].abs().max().item())
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, grads_ref):
        ok = ok and g.shape == r.shape and g.dtype == r.dtype
        if name.startswith("db"):
            d = (g - r).abs().max().item()
            parts.append(f"{name} {d:.3g} (|db| <= {r.abs().max().item():.3g}, tol "
                         f"{BLOCK_TOL['db_of_dw'] * dw_max:.3g})")
            ok = ok and d <= BLOCK_TOL["db_of_dw"] * dw_max
        else:
            c, rel = cos_rel(torch, g, r)
            parts.append(f"{name} cos {c:.6f}, rel L2 {rel:.3g}, max_abs_err "
                         f"{(g.float() - r.float()).abs().max().item():.3g}")
            ok = ok and c >= BLOCK_TOL["grad_cos"] and rel <= BLOCK_TOL["grad_rel_l2"]
    log("kernels", f"res_block64 {B}x64x{H}x{W} {dtype} against res_block64_reference: "
                   + "; ".join(parts))
    if not ok:
        fail(f"res_block64 disagrees with its plain version beyond {BLOCK_TOL}")
    del runs, y, grads, y_ref, grads_ref

    # the block forward, and forward+backward, in turns with the modular block (cuDNN)
    blk = ResidualBlock(64, 64, 1, dtype=dt).cuda()
    with torch.no_grad():
        for conv, w_, b_ in ((blk.conv1, params[0], params[1]), (blk.conv2, params[2], params[3])):
            conv.weight.copy_(w_)
            conv.bias.copy_(b_)
    xg = x.clone().requires_grad_(True)
    pg = [t.clone().requires_grad_(True) for t in params]

    def fwd(fn):
        def call():
            with torch.no_grad():
                fn()
        return call

    def kernel_block():
        return block_cuda.res_block64(xg, *pg)

    def library_block():
        return blk(xg)

    def fwd_bwd(fn):
        return lambda: fn().backward(dout)

    times = {}
    for mode, mk in (("forward", fwd), ("forward+backward", fwd_bwd)):
        t = {"kernel": [], "library": []}
        for _ in range(2):
            t["kernel"].append(median_ms(torch, mk(kernel_block), (), launches=5))
            t["library"].append(median_ms(torch, mk(library_block), (), launches=5))
        times[mode] = t
    log("kernels", "res_block64 block times (ms, in turns with ResidualBlock on cuDNN): "
                   + "; ".join(f"{m} kernel {'/'.join(f'{v:.4f}' for v in t['kernel'])}, "
                               f"library {'/'.join(f'{v:.4f}' for v in t['library'])}"
                               for m, t in times.items()))
    out["block_ms"] = {m: {k: sum(v) / len(v) for k, v in t.items()} for m, t in times.items()}
    del x, dout, params, xg, pg, blk
    torch.cuda.empty_cache()
    return out


def phase_stem(torch, np, stem_cuda) -> dict:
    """3f: ``stem_wgrad`` against its plain version, timed in turns with the
    library's weight grad of the s2d conv and of the x7 conv."""
    out = {}
    for case, B, H, W, dtype in STEM_CASES:
        x2, dy = stem_args(torch, np, B, H, W, dtype, seed=B + H)
        dk = stem_cuda.stem_wgrad(x2, dy)
        torch.cuda.synchronize()
        ref = stem_cuda.stem_wgrad_reference(x2, dy)
        # each side sums K products (exact for bf16 operands) of magnitude at
        # most m in f32 in its own order; partial sums of these zero-mean
        # terms stay near sqrt(k) m, so a chain's rounding errors add up to
        # about u m K / sqrt(2) at worst (one chain over all K): held to 4 u K m
        K = B * dy.shape[2] * dy.shape[3]
        tol = 4 * U32 * K * x2.float().abs().max().item() * dy.float().abs().max().item()
        if dk is None or dk.shape != ref.shape or dk.dtype != torch.float32:
            fail(f"stem_wgrad {case} returned {None if dk is None else (dk.shape, dk.dtype)}")
        err = (dk - ref).abs().max().item()
        O, C, KY, KX = ref.shape
        x7 = torch.cat([x2[:, :, ky:ky + 2 * dy.shape[2] - 1:2] for ky in range(KY)], dim=1)

        def library():
            return torch.nn.grad.conv2d_weight(x2, (O, C, KY, KX), dy, stride=(2, 1))

        def library_x7():
            return torch.nn.grad.conv2d_weight(x7, (O, KY * C, 1, KX), dy)

        k1 = median_ms(torch, stem_cuda.stem_wgrad, (x2, dy))
        l1 = median_ms(torch, library, ())
        x1 = median_ms(torch, library_x7, ())
        k2 = median_ms(torch, stem_cuda.stem_wgrad, (x2, dy))
        l2 = median_ms(torch, library, ())
        x7_2 = median_ms(torch, library_x7, ())
        plain_ms = median_ms(torch, stem_cuda.stem_wgrad_reference, (x2, dy), launches=3)
        bound_ms, bound_by = stem_bound(x2, dy, dtype)
        log("kernels", f"stem_wgrad {case} x2 {tuple(x2.shape)} dy {tuple(dy.shape)} {dtype} "
                       f"channels_last: max_abs_err {err:.3g} (tol {tol:.3g}, |dk| <= "
                       f"{ref.abs().max().item():.3g}); {k1:.4f}/{k2:.4f} ms, library wgrad "
                       f"{l1:.4f}/{l2:.4f} ms, x7 wgrad {x1:.4f}/{x7_2:.4f} ms (x7 built "
                       f"beforehand; in turns), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})")
        if err > tol:
            fail(f"stem_wgrad {case} disagrees with its plain version: {err} > {tol}")
        out[case] = dict(max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=(l1 + l2) / 2, x7_ms=(x1 + x7_2) / 2)
        del x2, dy, dk, ref, x7
    torch.cuda.empty_cache()
    return out


def require_full_f32(torch) -> None:
    """The f32 comparisons hold the kernels to plain versions whose matmuls
    and convs must keep full f32 products: TF32 off."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("the f32 comparisons need full-f32 matmuls and convs (TF32 is on)")


def phase_chanff_f32(torch, np, mixer_cuda) -> dict:
    """3g: ``chan_ff_bwd`` in f32 (the f32 kernel of ``csrc/chanff_bwd.cu``)
    against its plain version at the bench train shape, a ragged R and the
    training default, all seven grads, with its time and bound."""
    require_full_f32(torch)
    out = {}
    for R in (TRAIN_R, 800, TRAIN_R_DEFAULT):
        args = chanff_bwd_args(torch, np, R, seed=R + 3, dtype=torch.float32)
        before = mixer_cuda.bwd_f32_launches, mixer_cuda.bwd_launches
        got = mixer_cuda.chan_ff_bwd(*args)
        torch.cuda.synchronize()
        if (mixer_cuda.bwd_f32_launches, mixer_cuda.bwd_launches) != (before[0] + 1, before[1]):
            fail(f"chan_ff_bwd f32 R={R} did not launch the f32 kernel once")
        ref = mixer_cuda.chan_ff_bwd_reference(*args)
        tols = chanff_bwd_tols(torch, mixer_cuda, args)
        worst, parts, max_err = grad_errors(torch, f"chan_ff_bwd f32 R={R}", got, ref, tols)
        n = 20 if R < TRAIN_R_DEFAULT else 5
        ms = median_ms(torch, mixer_cuda.chan_ff_bwd, args, launches=n)
        plain_ms = median_ms(torch, mixer_cuda.chan_ff_bwd_reference, args, launches=n)
        bound_ms, bound_by = chanff_bwd_bound(R, "float32")
        log("kernels", f"chan_ff_bwd f32 R={R}: max_abs_err " + "; ".join(parts)
                       + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by})")
        if worst > 1.0:
            fail(f"chan_ff_bwd f32 R={R} disagrees with its plain version (worst err/tol "
                 f"{worst:.3g})")
        out[R] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
        del args, got, ref, tols
    torch.cuda.empty_cache()
    return out


def phase_chunk(torch, np, chunk_cuda, mixer_cuda) -> dict:
    """3h: the F-chunked channel block (``csrc/chanff_chunk.cu``), forward and
    backward, bf16, at the tool's R=1024 and a ragged R, against its plain
    versions at every chunk width the kernels take; at the tool's widths also
    timed in turns with the monolithic kernels on the same inputs."""
    out = {}
    for R in (TRAIN_R, 800):
        fargs = chanff_args(torch, np, R, torch.bfloat16, seed=R + 5)
        bargs = chanff_bwd_args(torch, np, R, seed=R + 6)
        tols = chanff_bwd_tols(torch, mixer_cuda, bargs)
        for fc in chunk_cuda.FCS:
            y = chunk_cuda.chan_ff_block_chunked(*fargs, fc=fc)
            grads = chunk_cuda.chan_ff_chunked_bwd(*bargs, fc=fc)
            torch.cuda.synchronize()
            ref = chunk_cuda.chan_ff_chunked_reference(*fargs, fc=fc)
            err = (y.float() - ref.float()).abs().max().item()
            tol = bf16_tol(ref.float().abs().max().item())
            gref = chunk_cuda.chan_ff_chunked_bwd_reference(*bargs, fc=fc)
            worst, parts, max_err = grad_errors(torch, f"chan_ff_chunked_bwd R={R} fc={fc}",
                                                grads, gref, tols)
            log("kernels", f"chunked block R={R} fc={fc} bf16: forward max_abs_err {err:.3g} "
                           f"(tol {tol:.3g}); backward " + "; ".join(parts))
            if not (y.shape == ref.shape and y.dtype == ref.dtype and err <= tol):
                fail(f"chan_ff_block_chunked R={R} fc={fc} disagrees with its plain version: "
                     f"{err} > {tol}")
            if worst > 1.0:
                fail(f"chan_ff_chunked_bwd R={R} fc={fc} disagrees with its plain version (worst "
                     f"err/tol {worst:.3g})")
            del y, grads, ref, gref
            if fc not in CHUNK_FCS:
                continue

            fwd = functools.partial(chunk_cuda.chan_ff_block_chunked, fc=fc)
            bwd = functools.partial(chunk_cuda.chan_ff_chunked_bwd, fc=fc)
            t = {k: [] for k in ("fwd", "base fwd", "bwd", "base bwd")}
            for _ in range(2):
                t["fwd"].append(median_ms(torch, fwd, fargs))
                t["base fwd"].append(median_ms(torch, mixer_cuda.chan_ff_block, fargs))
                t["bwd"].append(median_ms(torch, bwd, bargs))
                t["base bwd"].append(median_ms(torch, mixer_cuda.chan_ff_bwd, bargs))
            ms = {k: sum(v) / 2 for k, v in t.items()}
            plain = {"fwd": median_ms(torch, functools.partial(
                         chunk_cuda.chan_ff_chunked_reference, fc=fc), fargs, launches=5),
                     "bwd": median_ms(torch, functools.partial(
                         chunk_cuda.chan_ff_chunked_bwd_reference, fc=fc), bargs, launches=5)}
            bf, bf_by = chanff_bound(R, "bfloat16")
            bb, bb_by = chanff_bwd_bound(R)
            log("kernels", f"chunked block R={R} fc={fc} bf16: forward "
                           f"{'/'.join(f'{v:.4f}' for v in t['fwd'])} ms (monolithic "
                           f"{'/'.join(f'{v:.4f}' for v in t['base fwd'])}, in turns), plain "
                           f"{plain['fwd']:.4f}, bound {bf:.4f} ({bf_by}); backward "
                           f"{'/'.join(f'{v:.4f}' for v in t['bwd'])} ms (monolithic "
                           f"{'/'.join(f'{v:.4f}' for v in t['base bwd'])}), plain "
                           f"{plain['bwd']:.4f}, bound {bb:.4f} ({bb_by}); forward+backward "
                           f"{ms['fwd'] + ms['bwd']:.4f} ms, bound {bf + bb:.4f}")
            out[("fwd", R, fc)] = dict(max_abs_err=err, ms=ms["fwd"], plain_ms=plain["fwd"],
                                       bound_ms=bf, bound_by=bf_by, base_ms=ms["base fwd"])
            out[("bwd", R, fc)] = dict(max_abs_err=max_err, ms=ms["bwd"], plain_ms=plain["bwd"],
                                       bound_ms=bb, bound_by=bb_by, base_ms=ms["base bwd"])
        del fargs, bargs, tols
    torch.cuda.empty_cache()
    return out


def phase_chunk_f32(torch, np, chunk_cuda, mixer_cuda) -> None:
    """3h, f32: ``chan_ff_block_chunked`` and ``chan_ff_chunked_bwd`` on an
    f32 x at every width in ``FCS``, against the chunked plain versions in
    f32, with the f32 bounds of 3a (forward) and 3g (backward) and TF32 off.
    Each call must launch the f32 monolithic kernels once and no chunked
    kernel: in f32 the chunked block rounds nothing, so it is that block."""
    require_full_f32(torch)

    def counts():
        return (mixer_cuda.launches, mixer_cuda.bwd_f32_launches, chunk_cuda.launches,
                chunk_cuda.bwd_launches)

    for R in (TRAIN_R, 800):
        fargs = chanff_args(torch, np, R, torch.float32, seed=R + 7)
        bargs = chanff_bwd_args(torch, np, R, seed=R + 8, dtype=torch.float32)
        tols = chanff_bwd_tols(torch, mixer_cuda, bargs)
        for fc in chunk_cuda.FCS:
            before = counts()
            y = chunk_cuda.chan_ff_block_chunked(*fargs, fc=fc)
            grads = chunk_cuda.chan_ff_chunked_bwd(*bargs, fc=fc)
            torch.cuda.synchronize()
            if counts() != (before[0] + 1, before[1] + 1, before[2], before[3]):
                fail(f"f32 chunked block R={R} fc={fc}: launches {before} -> {counts()}, "
                     f"expected one f32 forward and one f32 backward of the monolithic kernels")
            ref = chunk_cuda.chan_ff_chunked_reference(*fargs, fc=fc)
            err = (y - ref).abs().max().item()
            gref = chunk_cuda.chan_ff_chunked_bwd_reference(*bargs, fc=fc)
            worst, parts, _ = grad_errors(torch, f"chan_ff_chunked_bwd f32 R={R} fc={fc}", grads,
                                          gref, tols)
            log("kernels", f"chunked block R={R} fc={fc} f32: forward max_abs_err {err:.3g} "
                           f"(tol {TOL_F32:.3g}); backward " + "; ".join(parts))
            if not (y.shape == ref.shape and y.dtype == ref.dtype and err <= TOL_F32):
                fail(f"chan_ff_block_chunked f32 R={R} fc={fc} disagrees with its plain version: "
                     f"{err} > {TOL_F32}")
            if worst > 1.0:
                fail(f"chan_ff_chunked_bwd f32 R={R} fc={fc} disagrees with its plain version "
                     f"(worst err/tol {worst:.3g})")
            del y, grads, ref, gref
        del fargs, bargs, tols
    torch.cuda.empty_cache()


def probe_bound(nbytes: float, ops: float, dtype: str):
    """Least time: the bytes over the HBM rate, or the operations at the
    dtype's peak (f32: outside the tensor cores)."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_probes(torch, F) -> dict:
    """3i: the Mosaic probe kernels against their plain versions on the
    three probe tools' inputs, with the tools' tolerances
    (``pips_tpu_torch/tools/_probes.py``); each timed beside its plain
    version, its bound and the library call that computes the same function
    where there is one. Returns the kernels line's numbers by entry name."""
    from pips_tpu_torch.kernels import corr_rows_cuda
    from pips_tpu_torch.tools import _probes, debug_mixer_kernel, debug_pallas7, probe_mosaic_ops

    require_full_f32(torch)  # the f32 plain versions of the products
    x, w1 = debug_mixer_kernel.inputs("cuda")
    fmap, targets, coords = debug_pallas7.inputs("cuda")
    a, b = probe_mosaic_ops.inputs("cuda")
    probes = {**debug_mixer_kernel.probes(x, w1), **debug_pallas7.probes(fmap, targets, coords),
              **probe_mosaic_ops.probes(a, b)}
    # the JAX tool's probe -> (kernels-line name, library call or None, bytes, operations, dtype)
    M, K, NB, N = x.shape[0], debug_mixer_kernel.D, w1.shape[0], w1.shape[2]
    a_cat = x[:, :K].repeat(1, NB)  # K-concatenated operands of the library's one product
    w_cat = w1.reshape(NB * K, N)
    H, W, r = debug_pallas7.H, debug_pallas7.W, debug_pallas7.r
    idx, valid = corr_rows_cuda._window(coords, H, W, r)
    rows_read = idx[valid].unique().numel()  # distinct map rows the patches touch
    S, Np, C = targets.shape
    TH, Wo, Ca, O, T = (probe_mosaic_ops.TH, probe_mosaic_ops.Wo, probe_mosaic_ops.C,
                        probe_mosaic_ops.O, probe_mosaic_ops.TILES)
    ab_bytes = 2 * TH * Wo * (Ca + O) + 4 * Ca * O
    einsum_a = lambda: torch.einsum("hwc,hwo->co", a, b)  # noqa: E731
    meta = {
        "erf": ("gelu", lambda: F.gelu(x), 4 * x.numel(), 5 * x.numel(), "float32"),
        "ln_slice": ("ln_slice", lambda: F.layer_norm(x[:, :K], (K,)), 4 * M * K, 5 * M * K,
                     "float32"),
        "block_stream_accum": ("stream_accum", lambda: torch.mm(a_cat, w_cat),
                               2 * M * K + 2 * NB * K * N + 4 * M * N, 2 * M * N * K * NB,
                               "bfloat16"),
        "rowwise 3d-reduce": ("corr_rows", None,
                              4 * (rows_read * C + targets.numel() + coords.numel()
                                   + Np * S * (2 * r + 1) ** 2),
                              2 * C * int(valid.sum().item()), "float32"),
        "A dot2contract": ("row_contract_a", einsum_a, ab_bytes, 2 * TH * Wo * Ca * O,
                           "bfloat16"),
        "A2 collapse3d->2d": ("row_contract_a2", einsum_a, ab_bytes, 2 * TH * Wo * Ca * O,
                              "bfloat16"),
        "B minorsplit": ("row_contract_b", einsum_a, ab_bytes, 2 * TH * Wo * Ca * O, "bfloat16"),
        "C laneconcat": ("row_contract_c",
                         lambda: torch.einsum("hic,ho->ico", a[:, :T], b[:, 0]),
                         2 * TH * (T * Ca + O) + 4 * T * Ca * O, 2 * T * TH * Ca * O,
                         "bfloat16")}
    if sorted(meta) != sorted(probes):
        fail(f"3i: probes {sorted(probes)}, expected {sorted(meta)}")
    out = {}
    for probe, p in probes.items():
        entry, library, nbytes, ops, dtype = meta[probe]
        got = p.kernel()
        torch.cuda.synchronize()
        try:
            err, worst = _probes.check(probe, got, p.plain(),
                                       None if p.terms is None else p.terms(),
                                       None if p.slack is None else p.slack())
        except RuntimeError as e:
            fail(f"3i: {e}")
        ms = median_ms(torch, p.kernel, ())
        plain_ms = median_ms(torch, p.plain, ())
        lib_ms = None if library is None else median_ms(torch, library, ())
        bound_ms, bound_by = probe_bound(nbytes, ops, dtype)
        log("kernels", f"{entry} ({probe}): max_abs_err {err:.3g} (worst err/tol {worst:.3g}); "
                       f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                       f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                       f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.3f} MB, "
                       f"{ops / 1e9:.4f} GFLOP)")
        out[entry] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
    del x, w1, a_cat, w_cat, fmap, targets, coords, a, b, probes
    torch.cuda.empty_cache()
    return out


def phase_probe_tools(torch) -> dict:
    """9, the probes: the three probe tools' ``main`` on the card, their
    kernels' launch counts zeroed before each and read after; the tools
    raise on any probe that misses its tolerance."""
    from pips_tpu_torch.kernels import corr_rows_cuda, mixer_probes_cuda, row_contract_cuda
    from pips_tpu_torch.tools import debug_mixer_kernel, debug_pallas7, probe_mosaic_ops

    got = {}  # by kernels-line name: the counter's key, after the prefix
    for tool, counts, prefix in (
            (debug_mixer_kernel, lambda: dict(mixer_probes_cuda.launches), ""),
            (debug_pallas7, lambda: {"corr_rows": corr_rows_cuda.launches}, ""),
            (probe_mosaic_ops, lambda: dict(row_contract_cuda.launches), "row_contract_")):
        mixer_probes_cuda.launches.clear()
        row_contract_cuda.launches.clear()
        corr_rows_cuda.launches = 0
        t = time.perf_counter()
        res = tool.main()
        n, want = counts(), tool.kernel_launches()
        log("tools", f"{tool.__name__.rsplit('.', 1)[-1]}.main() in "
                     f"{time.perf_counter() - t:.1f} s: {json.dumps(res)}; launches {n} "
                     f"(expected {want})")
        if n != want or not all(math.isfinite(v) for r in res.values() for v in r.values()):
            fail(f"{tool.__name__}: launches {n}, expected {want}; {res}")
        got.update({prefix + k.lower(): v for k, v in n.items()})
    return got


def phase_tools(torch, block_cuda, stem_cuda, chunk_cuda) -> dict:
    """9: the slices' paths, the three profiling tools' ``main`` on the card,
    with their kernels' launch counts zeroed before and read after."""
    from pips_tpu_torch.tools import profile_block_kernel, profile_chanff_chunk, profile_stem_wgrad

    block_cuda.launches = 0
    t = time.perf_counter()
    res = profile_block_kernel.main()
    n_block, want = block_cuda.launches, profile_block_kernel.kernel_launches()
    log("tools", f"profile_block_kernel.main() in {time.perf_counter() - t:.1f} s: "
                 f"{json.dumps(res)}; {n_block} conv_pass launches (expected {want})")
    if n_block != want or not all(math.isfinite(v) and v > 0 for v in res.values()):
        fail(f"profile_block_kernel: {n_block} launches, expected {want}; {res}")
    stem_cuda.launches = 0
    t = time.perf_counter()
    res_s = profile_stem_wgrad.main()
    n_stem = stem_cuda.launches
    want = len(profile_stem_wgrad.SHAPES) * profile_stem_wgrad.kernel_launches()
    log("tools", f"profile_stem_wgrad.main() in {time.perf_counter() - t:.1f} s: "
                 f"{json.dumps(res_s)}; {n_stem} stem_wgrad launches (expected {want})")
    if n_stem != want or not all(math.isfinite(v) for r in res_s.values() for v in r.values()):
        fail(f"profile_stem_wgrad: {n_stem} launches, expected {want}; {res_s}")
    # the kernel's dk against the library's (rounded to bf16 as the weight's dtype)
    if max(r["rel"] for r in res_s.values()) > 2.0 ** -7:
        fail(f"profile_stem_wgrad: dk differs from the library's beyond a bf16 ulp: {res_s}")
    chunk_cuda.launches = chunk_cuda.bwd_launches = 0
    t = time.perf_counter()
    res_c = profile_chanff_chunk.main()
    got = chunk_cuda.launches, chunk_cuda.bwd_launches
    want = profile_chanff_chunk.kernel_launches()
    log("tools", f"profile_chanff_chunk.main() in {time.perf_counter() - t:.1f} s: "
                 f"{json.dumps(res_c)}; chunked forward and backward "
                 f"launches {got} (expected {want}: 12 per chain forward, 12 per chain backward)")
    times = [v for mode in ("fwd", "fwd+bwd") for v in res_c[mode].values()]
    if got != want or not all(math.isfinite(v) and v > 0 for v in times):
        fail(f"profile_chanff_chunk: launches {got}, expected {want}; {res_c}")
    # both chains keep the products in f32 and round each block's output once,
    # in other summation orders: 16 bf16 ulps at the output's largest magnitude
    # hold a flip at every block carried through the rest of the chain
    bound = 8 * bf16_tol(res_c["y_absmax"])
    if max(res_c["parity"].values()) > bound:
        fail(f"profile_chanff_chunk: a chunked chain differs from the base chain by more than "
             f"{bound}: {res_c['parity']}")
    return {"res_block64": n_block, "stem_wgrad": n_stem, "chan_ff_chunked_fwd": got[0],
            "chan_ff_chunked_bwd": got[1]}


def train_batch(torch, np, cfg: dict, seed: int) -> dict:
    """A batch of ``cfg["B"]`` synthetic samples on the card."""
    from pips_tpu_torch.data import SyntheticPointDataset

    ds = SyntheticPointDataset(S=8, N=cfg["N"], H=cfg["H"], W=cfg["W"], seed=seed)
    samples = [ds[i][0] for i in range(cfg["B"])]
    return {k: torch.from_numpy(np.stack([x[k] for x in samples])).cuda() for k in samples[0]}


def zero_grad_leaf(name: str) -> bool:
    """Biases that a following normalisation removes: their grads are zero in
    exact math and rounding noise in practice."""
    return ((name.startswith("fnet.") and name.endswith(".bias")
             and not name.startswith("fnet.conv3.")) or
            (name.endswith("_token.fc2.bias")))


def zero_train_counts(mixer_cuda, corr_cuda) -> None:
    mixer_cuda.launches = mixer_cuda.bwd_launches = mixer_cuda.bwd_f32_launches = 0
    corr_cuda.launches = 0


def train_counts(mixer_cuda, corr_cuda) -> tuple:
    """Launches so far of the channel block's forward, its bf16 and its f32
    backward, and the corr kernel: the order of ``TRAIN_KERNELS``."""
    return (mixer_cuda.launches, mixer_cuda.bwd_launches, mixer_cuda.bwd_f32_launches,
            corr_cuda.launches)


def step_launches(torch, dtype, iters: int, steps: int = 1) -> tuple:
    """``train_counts`` of ``steps`` train steps at ``iters`` refinement
    iterations: 12 channel-block forwards and 12 backwards in the model's
    dtype per iteration, no corr kernel (training samples through onehot)."""
    n = DEPTH * iters * steps
    f32 = dtype == torch.float32
    return (n, 0 if f32 else n, n if f32 else 0, 0)


def add_launches(total: dict, got: tuple) -> None:
    """Add ``train_counts``' launches to a tally of the kernels line."""
    for name, n in zip(TRAIN_KERNELS, got):
        total[name] = total.get(name, 0) + n


@contextlib.contextmanager
def channel_blocks_as(mixer_cuda, forward, backward):
    """Run the channel block's autograd Function on other forward and
    backward functions (a plain version) in place of the kernels."""
    kernels = mixer_cuda._forward, mixer_cuda.chan_ff_bwd
    mixer_cuda._forward, mixer_cuda.chan_ff_bwd = forward, backward
    try:
        yield
    finally:
        mixer_cuda._forward, mixer_cuda.chan_ff_bwd = kernels


def loss_and_grads(torch, model, batch, cfg: dict, iters: int):
    """One train step's metrics and every leaf's grad in f32, nothing applied."""
    from pips_tpu_torch.train import apply_flip_doubling, train_loss_fn

    model.zero_grad(set_to_none=True)
    total, metrics = train_loss_fn(model, apply_flip_doubling(batch, *cfg["flips"]), iters)
    total.backward()
    torch.cuda.synchronize()
    out = ({k: float(v.detach()) for k, v in metrics.items()},
           {n: p.grad.detach().float().clone() for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return out


def grad_parity(torch, step, plain) -> dict:
    """A step's (metrics, grads) against a plain step's: the loss's relative
    error and, in f64 over the leaves whose grad is not zero in exact math, the
    cosine and relative L2 distance of all grads together, and the worst leaf
    cosine overall, in the encoder and outside it."""
    (km, kg), (pm, pg) = step, plain
    cos_of = {n: cos_rel(torch, g, pg[n])[0] for n, g in kg.items() if not zero_grad_leaf(n)}
    global_cos, global_rel = cos_rel(torch, torch.cat([kg[n].ravel() for n in cos_of]),
                                     torch.cat([pg[n].ravel() for n in cos_of]))
    enc = min((n for n in cos_of if n.startswith("fnet.")), key=cos_of.get)
    mix = min((n for n in cos_of if not n.startswith("fnet.")), key=cos_of.get)
    return dict(loss_rel=abs(km["total_loss"] - pm["total_loss"]) / abs(pm["total_loss"]),
                global_cos=global_cos, global_rel=global_rel, leaf_cos=min(cos_of.values()),
                encoder_cos=cos_of[enc], mixer_cos=cos_of[mix], encoder_leaf=enc, mixer_leaf=mix,
                below=sum(v < 0.999 for v in cos_of.values()), leaves=len(cos_of))


def parity_step(torch, mixer_cuda, corr_cuda, model, batch, dtype, iters: int, bounds: dict,
                phase: str, witness=None) -> tuple:
    """(a) of phases 7 and 7d: one step's loss and grads at the bench train
    shape with ``iters`` refinement iterations, the kernels against the plain
    channel block (forward and backward). Fails on a launch count, or past
    ``bounds`` (``grad_parity``'s keys: ``loss_rel`` at most, each cosine at
    least). ``witness``, a (forward, backward) pair, runs a third step through
    another plain version of the block, held against the plain step and
    printed, not bounded: the reading of how far summation order alone moves
    the step. Returns the kernels' ``train_counts``."""
    zero_train_counts(mixer_cuda, corr_cuda)
    k = loss_and_grads(torch, model, batch, TRAIN, iters)
    got, want = train_counts(mixer_cuda, corr_cuda), step_launches(torch, dtype, iters)
    if got != want:
        fail(f"{phase} parity step I={iters}: {TRAIN_KERNELS} launched {got} times, "
             f"expected {want}")

    def plain_step(forward, backward):
        with channel_blocks_as(mixer_cuda, forward, backward):
            zero_train_counts(mixer_cuda, corr_cuda)
            out = loss_and_grads(torch, model, batch, TRAIN, iters)
            if any(train_counts(mixer_cuda, corr_cuda)):
                fail(f"the plain channel block launched kernels: "
                     f"{train_counts(mixer_cuda, corr_cuda)}")
        return out

    p = plain_step(mixer_cuda.chan_ff_reference, mixer_cuda.chan_ff_bwd_reference)
    r = grad_parity(torch, k, p)
    (km, _), (pm, _) = k, p
    msg = (f"parity step (B={TRAIN['B']} N={TRAIN['N']} I={iters} {TRAIN['H']}x{TRAIN['W']}, "
           f"{str(dtype).split('.')[-1]}): loss {km['total_loss']:.6g} (seq {km['seq']:.4g}, vis "
           f"{km['vis']:.4g}, ce {km['ce']:.4g}) vs plain {pm['total_loss']:.6g}, rel "
           f"{r['loss_rel']:.3g}; grads: global cos {r['global_cos']:.7f}, rel L2 "
           f"{r['global_rel']:.3g}; worst leaf cos in the encoder {r['encoder_cos']:.7f} "
           f"({r['encoder_leaf']}), outside it {r['mixer_cos']:.7f} ({r['mixer_leaf']}); "
           f"{r['below']} of {r['leaves']} below 0.999; {got[0]} + {got[1] + got[2]} launches")
    del k
    if witness is not None:
        w = grad_parity(torch, plain_step(*witness), p)
        msg += (f"; plain in F chunks of {WITNESS_FC} against plain: loss rel {w['loss_rel']:.3g}, "
                f"global cos {w['global_cos']:.7f}, worst leaf cos {w['leaf_cos']:.7f} ("
                f"{w['encoder_leaf'] if w['encoder_cos'] <= w['mixer_cos'] else w['mixer_leaf']}),"
                f" {w['below']} of {w['leaves']} below 0.999")
    del p
    log(phase, msg)
    bad = {k: r[k] for k, b in bounds.items() if (r[k] > b if k == "loss_rel" else r[k] < b)}
    if bad:
        fail(f"{phase}: the step with the kernels differs from the plain channel block at "
             f"I={iters} beyond {bounds}: {bad}")
    return got


def timed_steps(torch, mixer_cuda, corr_cuda, model, batch, dtype, n: int, phase: str):
    """(c) of phases 7 and 7d: a warm-up and ``n`` timed train steps at the
    training default (host clock around each synchronised step), each with
    its launches checked and finite metrics. Returns the median step ms,
    points*frames/s and peak memory, and the launches of all ``n + 1``."""
    from pips_tpu_torch.train import make_optimizer, make_train_step

    opt = make_optimizer(model.parameters(), lr=5e-4, num_steps=100)
    step = make_train_step(model, opt, iters=TRAIN_DEFAULT["iters"], horz_flip=True,
                           vert_flip=True)
    want = step_launches(torch, dtype, TRAIN_DEFAULT["iters"])
    zero_train_counts(mixer_cuda, corr_cuda)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(n):
        before = train_counts(mixer_cuda, corr_cuda)
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        got = tuple(a - b for a, b in zip(train_counts(mixer_cuda, corr_cuda), before))
        if got != want:
            fail(f"a default train step in {dtype} launched {TRAIN_KERNELS} {got} times, "
                 f"expected {want}")
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"non-finite metrics at the training default in {dtype}: {m}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med_s = statistics.median(step_s)
    pf = 4 * TRAIN_DEFAULT["N"] * 8 / med_s
    c = TRAIN_DEFAULT
    log(phase, f"training default (B={c['B']} x4 flips, N={c['N']}, I={c['iters']}, "
               f"{c['H']}x{c['W']}, {str(dtype).split('.')[-1]}): steps "
               f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, median {med_s * 1e3:.1f} ms; "
               f"{pf:.0f} points*frames/s (4 x {c['N']} x 8 per step); "
               f"peak memory {peak_gb:.2f} GB; {want[0]} chan_ff_block + {want[1] + want[2]} "
               f"chan_ff_bwd launches per step; total_loss {m['total_loss']:.4g}")
    return (dict(step_ms=med_s * 1e3, points_frames_per_s=pf, peak_gb=peak_gb),
            train_counts(mixer_cuda, corr_cuda))


def phase_train_f32(torch, np, mixer_cuda, chunk_cuda, corr_cuda, build_dir: Path) -> dict:
    """7d: the full-width model in f32 with fused channel blocks, the path of
    the f32 backward kernel: (a) one step's loss and grads at the bench train
    shape against the plain channel block, with I=1 and with I=6 (and at I=6
    the plain block in F chunks against the plain block, the witness for
    PARITY's looser bounds); (b) ``train.loop.main`` with ``--dtype float32
    --fuse_chanff 1`` for 12 steps with a validation pass and a checkpoint;
    (c) 2 timed steps at the training default. Returns the launches of the
    forward and f32 backward kernels and the step numbers."""
    from pips_tpu_torch import make_pips
    from pips_tpu_torch.train import parse_cli
    from pips_tpu_torch.train import loop as train_loop
    from pips_tpu_torch.utils import saverloader

    require_full_f32(torch)
    launched = {}
    f32 = torch.float32

    # (a) one step's loss and grads, kernels against the plain channel block,
    # with one refinement iteration and with the bench shape's six
    model = make_pips(device="cuda", seed=0, dtype=None, fuse_chanff=True).train()
    batch = train_batch(torch, np, TRAIN, seed=0)
    add_launches(launched, parity_step(torch, mixer_cuda, corr_cuda, model, batch, f32, 1,
                                       PARITY_F32, "train f32"))
    witness = (functools.partial(chunk_cuda.chan_ff_chunked_reference, fc=WITNESS_FC),
               functools.partial(mixer_cuda.chan_ff_bwd_reference, fc=WITNESS_FC))
    add_launches(launched, parity_step(torch, mixer_cuda, corr_cuda, model, batch, f32,
                                       TRAIN["iters"], PARITY, "train f32", witness))
    del model, batch
    torch.cuda.empty_cache()

    # (b) the loop's own entry point, as a user runs it
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_f32_", dir=build_dir))
    argv = ["--dtype", "float32", "--fuse_chanff", "1", "--dataset", "synthetic",
            "--B", str(TRAIN["B"]), "--N", str(TRAIN["N"]), "--I", str(TRAIN["iters"]),
            "--crop_size", f"{TRAIN['H']},{TRAIN['W']}", "--horz_flip", "false",
            "--vert_flip", "false", "--max_iters", str(LOOP_F32_STEPS),
            "--save_freq", str(LOOP_F32_STEPS), "--val_freq", str(LOOP_F32_STEPS),
            "--val_batches", "1", "--log_freq", str(LOOP_F32_STEPS), "--log_media", "false",
            "--metrics_every", "1", "--num_workers", "4", "--ckpt_dir", str(root / "ckpts"),
            "--log_dir", str(root / "logs")]
    cfg = parse_cli(argv)
    zero_train_counts(mixer_cuda, corr_cuda)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = train_loop.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    want = (DEPTH * cfg.I * (LOOP_F32_STEPS + cfg.val_batches), 0, DEPTH * cfg.I * LOOP_F32_STEPS,
            0)
    got = train_counts(mixer_cuda, corr_cuda)
    if got != want:
        fail(f"the f32 loop: {TRAIN_KERNELS} launched {got} times, expected {want}")
    add_launches(launched, got)
    losses = [float(v) for v in re.findall(r"loss = ([0-9.eE+-]+)", buf.getvalue())]
    if len(losses) != LOOP_F32_STEPS or not all(math.isfinite(v)
                                                for v in losses + [*metrics.values()]):
        fail(f"the f32 loop: {len(losses)} step losses, metrics {metrics}")
    head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    steps_saved = saverloader.list_steps(str(root / "ckpts" / cfg.model_name()))
    log("train f32", f"train.loop.main({' '.join(argv[:4])} ...): {LOOP_F32_STEPS} steps, a "
                     f"validation pass and a checkpoint in {secs:.1f} s; total_loss "
                     f"{' '.join(f'{v:.4g}' for v in losses)}; checkpoints {steps_saved}; "
                     f"launches {got}")
    if not tail < head:
        fail(f"the f32 loop's loss did not fall: first three {head:.4g}, last three {tail:.4g}")
    if steps_saved != [LOOP_F32_STEPS]:
        fail(f"the f32 loop's checkpoints are {steps_saved}, expected [{LOOP_F32_STEPS}]")
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    # (c) timed steps at the training default
    model = make_pips(device="cuda", seed=0, dtype=None, fuse_chanff=True).train()
    big = train_batch(torch, np, TRAIN_DEFAULT, seed=1)
    numbers, got = timed_steps(torch, mixer_cuda, corr_cuda, model, big, f32, 2, "train f32")
    add_launches(launched, got)
    del model, big
    torch.cuda.empty_cache()
    return dict(launched=launched, **numbers, loop_s=secs)


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
    import torch.nn.functional as F

    from pips_tpu_torch.kernels import (_build, block_cuda, chanff_chunk_cuda, conv_cuda, corr_cuda,
                                        corr_rows_cuda, mixer_cuda, mixer_probes_cuda,
                                        row_contract_cuda, stem_wgrad_cuda)
    from pips_tpu_torch.models import mixer as mixer_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def zero_counts():
        mixer_cuda.launches = 0
        mixer_cuda.bwd_launches = 0
        mixer_cuda.bwd_f32_launches = 0
        chanff_chunk_cuda.launches = 0
        chanff_chunk_cuda.bwd_launches = 0
        corr_cuda.launches = 0
        conv_cuda.launches = 0
        block_cuda.launches = 0
        stem_wgrad_cuda.launches = 0
        mixer_probes_cuda.launches.clear()
        corr_rows_cuda.launches = 0
        row_contract_cuda.launches.clear()

    def counts():
        return mixer_cuda.launches, corr_cuda.launches

    # launches summed over main-path runs
    main_path = {"chan_ff_block": 0, "corr_sample": 0, "chan_ff_bwd": 0, "conv3x3_same": 0,
                 "res_block64": 0, "stem_wgrad": 0, "chan_ff_bwd_f32": 0,
                 "chan_ff_chunked_fwd": 0, "chan_ff_chunked_bwd": 0, "gelu": 0, "ln_slice": 0,
                 "stream_accum": 0, "corr_rows": 0, "row_contract_a": 0, "row_contract_a2": 0,
                 "row_contract_b": 0, "row_contract_c": 0}

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

    # 3a. chan_ff_block against its plain version, at the main path's shapes:
    # the served windows' (R_MAIN, and 2000, no multiple of the kernel's row
    # blocks) in bf16 and f32, and the f32 train path's (the bench train shape
    # and the training default)
    require_full_f32(torch)
    R_MAIN = 1 * 256 * 8  # B*N*S of the first request
    chanff = {}
    for dtype in ("bfloat16", "float32"):
        for R in (R_MAIN, 2000) + ((TRAIN_R, TRAIN_R_DEFAULT) if dtype == "float32" else ()):
            args = chanff_args(torch, np, R, getattr(torch, dtype), seed=R)
            y = mixer_cuda.chan_ff_block(*args)
            torch.cuda.synchronize()
            ref = mixer_cuda.chan_ff_reference(*args)
            err = (y.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = bf16_tol(ref_max) if dtype == "bfloat16" else TOL_F32
            n = 20 if R < TRAIN_R_DEFAULT else 5
            ms = median_ms(torch, mixer_cuda.chan_ff_block, args, launches=n)
            plain_ms = median_ms(torch, mixer_cuda.chan_ff_reference, args, launches=n)
            bound_ms, bound_by = chanff_bound(R, dtype)
            log("kernels", f"chan_ff_block {dtype} R={R}: max_abs_err {err:.3g} (tol {tol:.3g}, "
                           f"|y| <= {ref_max:.3g}); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                           f"bound {bound_ms:.4f} ms ({bound_by})")
            if not (y.shape == ref.shape and err <= tol):
                fail(f"chan_ff_block {dtype} R={R} disagrees with its plain version: {err} > {tol}")
            chanff[(dtype, R)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            del args, y, ref
    torch.cuda.empty_cache()

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
        worst, parts, max_err = grad_errors(torch, f"chan_ff_bwd R={R}", out, ref, tols)
        ms = median_ms(torch, mixer_cuda.chan_ff_bwd, args)
        plain_ms = median_ms(torch, mixer_cuda.chan_ff_bwd_reference, args)
        bound_ms, bound_by = chanff_bwd_bound(R)
        log("kernels", f"chan_ff_bwd bf16 R={R}: max_abs_err " + "; ".join(parts)
                       + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by})")
        if worst > 1.0:
            fail(f"chan_ff_bwd R={R} disagrees with its plain version (worst err/tol {worst:.3g})")
        chanff_bwd[R] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        del args, out, ref, tols
    torch.cuda.empty_cache()

    # 3d. conv3x3_same against its plain version, forward and dx (the same
    # kernel on dy with the rotated, in/out-swapped weights), at the encoder's
    # stage-1 shapes; timed in turns with F.conv2d in x's dtype (cuDNN), the
    # one PyTorch call that computes the same conv
    conv = {}
    for case, B, H, W, dtype in CONV_SHAPES:
        x, w, b, dy = conv_args(torch, np, B, H, W, dtype, seed=B + H)
        w_rot = w.to(x.dtype).flip(2, 3).transpose(0, 1)
        zero = torch.zeros(64, device="cuda")
        outs = {"y": conv_cuda.conv3x3_same(x, w, b), "dx": conv_cuda.conv3x3_same(dy, w_rot, zero)}
        torch.cuda.synchronize()
        refs = {"y": conv_cuda.conv3x3_reference(x, w, b),
                "dx": conv_cuda.conv3x3_reference(dy, w_rot, zero)}
        parts, errs = [], {}
        for name, out in outs.items():
            ref = refs[name]
            err = (out.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = bf16_tol(ref_max) if dtype == "bfloat16" else TOL_F32
            parts.append(f"{name} {err:.3g} (tol {tol:.3g}, |{name}| <= {ref_max:.3g})")
            same_format = out.is_contiguous(memory_format=torch.channels_last)
            if not (out.shape == ref.shape and out.dtype == ref.dtype and same_format
                    and err <= tol):
                fail(f"conv3x3_same {case} {name} disagrees with its plain version: {err} > {tol}")
            errs[name] = err
        if case == "bench train":  # dW and db through the autograd Function
            leaves = {}
            for side, fn in (("kernel", conv_cuda.conv3x3_same),
                             ("plain", conv_cuda.conv3x3_reference)):
                xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
                fn(xg, wg.to(x.dtype), bg).backward(dy)
                leaves[side] = {"dx": xg.grad, "dW": wg.grad, "db": bg.grad}
            torch.cuda.synchronize()
            for name, g in leaves["kernel"].items():
                r = leaves["plain"][name]
                err = (g.float() - r.float()).abs().max().item()
                tol = bf16_tol(r.float().abs().max().item())
                parts.append(f"Function {name} {err:.3g} (tol {tol:.3g})")
                if not (g.shape == r.shape and g.dtype == r.dtype and err <= tol):
                    fail(f"conv3x3_same's backward {name} disagrees with autograd of the plain "
                         f"version: {err} > {tol}")
        args = (x, w, b)
        wl, bl = w.to(x.dtype), b.to(x.dtype)

        def library():
            return F.conv2d(x, wl, bl, padding=1)

        k1 = median_ms(torch, conv_cuda.conv3x3_same, args)
        l1 = median_ms(torch, library, ())
        k2 = median_ms(torch, conv_cuda.conv3x3_same, args)
        l2 = median_ms(torch, library, ())
        plain_ms = median_ms(torch, conv_cuda.conv3x3_reference, args)
        bound_ms, bound_by = conv_bound(B, H, W, dtype)
        ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
        log("kernels", f"conv3x3_same {case} {B}x64x{H}x{W} {dtype} channels_last: max_abs_err "
                       + "; ".join(parts) + f"; {k1:.4f}/{k2:.4f} ms, F.conv2d {l1:.4f}/{l2:.4f} "
                       f"ms (in turns), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})")
        conv[case] = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        del x, w, b, dy, w_rot, outs, refs
    torch.cuda.empty_cache()

    # 3e. the residual block's conv pass and the whole block; 3f. the stem
    # weight gradient: each against its plain version, timed in turns with
    # the library
    block = phase_block(torch, np, F, block_cuda)
    stem = phase_stem(torch, np, stem_wgrad_cuda)

    # 3g. the f32 backward of the channel block; 3h. the F-chunked channel
    # block, forward and backward, in bf16 and in f32: each against its plain
    # version
    chanff_f32 = phase_chanff_f32(torch, np, mixer_cuda)
    chunk = phase_chunk(torch, np, chanff_chunk_cuda, mixer_cuda)
    phase_chunk_f32(torch, np, chanff_chunk_cuda, mixer_cuda)

    # 3i. the Mosaic probe kernels of the three probe tools
    probes = phase_probes(torch, F)

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

    window_ms = {}
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

    # 4b. the first window with fuse_conv3: the encoder's four stage-1 convs
    # through the conv kernel, against the same weights without it. The
    # kernel adds the bias before its one bf16 rounding, the plain conv after
    # it, so the two differ by bf16 rounding: one iteration within ONE_ITER,
    # six within the drift bounds.
    model_c = make_pips(device="cuda", seed=0, dtype=torch.bfloat16, fuse_chanff=True,
                        fuse_conv3=True)
    tracker_c = WindowTracker(model_c, iters=ITERS, corr_mode="onehot")
    name, rgbs, xys, trajs, vis, _ = served[0]
    zero_counts()
    c_trajs, c_vis = tracker_c(xys, rgbs)
    n_conv, n_ff = conv_cuda.launches, mixer_cuda.launches
    check_window(np, f"fuse_conv3 {name}", c_trajs, c_vis, xys)
    if n_conv != CONV_PER_ENCODE or n_ff != DEPTH * ITERS:
        fail(f"fuse_conv3 {name}: conv3x3_same launched {n_conv} and chan_ff_block {n_ff} times, "
             f"expected {CONV_PER_ENCODE} and {DEPTH * ITERS}")
    main_path["conv3x3_same"] += n_conv
    main_path["chan_ff_block"] += n_ff
    one = drift(np, *WindowTracker(model_c, iters=1, corr_mode="onehot")(xys, rgbs),
                *tracker1(xys, rgbs))
    six = drift(np, c_trajs, c_vis, trajs, vis)
    times = {"plain convs": [], "fuse_conv3": []}
    for _ in range(7):
        times["plain convs"].append(window_seconds(torch, tracker, xys, rgbs))
        times["fuse_conv3"].append(window_seconds(torch, tracker_c, xys, rgbs))
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    log("slice", f"fuse_conv3 {name}: {n_conv} conv + {n_ff} chan_ff launches; vs plain convs: "
                 f"1 iter traj max {one['max']:.3g} px, vis max {one['vis_max']:.3g}; 6 iters "
                 f"{fmt(six)}; median window over 7, in turns: plain convs "
                 f"{med['plain convs']:.2f} ms, fuse_conv3 {med['fuse_conv3']:.2f} ms (host clock)")
    check_drift(f"fuse_conv3 {name}", one, six)
    window_ms["fuse_conv3 " + name] = med
    del model_c, tracker_c
    torch.cuda.empty_cache()

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
    from pips_tpu_torch.train import make_optimizer, make_train_step

    torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    train_model = make_pips(device="cuda", seed=0, dtype=bf16, fuse_chanff=True).train()
    batch = train_batch(torch, np, TRAIN, seed=0)
    # (a) one step's loss and grads, kernels against the plain channel block
    add_launches(main_path, parity_step(torch, mixer_cuda, corr_cuda, train_model, batch, bf16,
                                        TRAIN["iters"], PARITY, "train"))

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
    got = train_counts(mixer_cuda, corr_cuda)
    if got != step_launches(torch, bf16, TRAIN["iters"], TRAIN_RUN_STEPS):
        fail(f"the 20-step run launched {TRAIN_KERNELS} {got} times")
    add_launches(main_path, got)
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
    big = train_batch(torch, np, TRAIN_DEFAULT, seed=1)
    train_default, got = timed_steps(torch, mixer_cuda, corr_cuda, train_model, big, bf16, 3,
                                     "train")
    add_launches(main_path, got)

    # 8. slice: the train loop end to end with fuse_conv3, at full width on the
    # synthetic set at the bench train shape; media at 384x512 render the
    # score maps too (a second forward)
    from pips_tpu_torch.train import TrainConfig
    from pips_tpu_torch.train.loop import train as train_loop
    from pips_tpu_torch.utils import saverloader

    del train_model, big
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_", dir=build_dir))
    cfg = TrainConfig(B=TRAIN["B"], N=TRAIN["N"], I=TRAIN["iters"],
                      crop_size=(TRAIN["H"], TRAIN["W"]), horz_flip=False, vert_flip=False,
                      dataset="synthetic", dtype="bfloat16",
                      fuse_chanff=-1, fuse_conv3=1, max_iters=LOOP_STEPS, save_freq=LOOP_EVERY,
                      val_freq=LOOP_EVERY, log_freq=LOOP_EVERY, val_batches=2, log_media=True,
                      metrics_every=1, num_workers=4, ckpt_dir=str(root / "ckpts"),
                      log_dir=str(root / "logs"))
    run_dir = root / "ckpts" / cfg.model_name()

    def loop_run(c, first_step: int):
        zero_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            metrics = train_loop(c, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        out = buf.getvalue()
        steps = c.max_iters - first_step
        events = sum(1 for k in range(first_step + 1, c.max_iters + 1) if k % LOOP_EVERY == 0)
        want_conv = 2 * CONV_PER_ENCODE * steps + CONV_PER_ENCODE * (c.val_batches + 1) * events
        want_fwd = DEPTH * c.I * (steps + (c.val_batches + 1) * events)
        got = (conv_cuda.launches, mixer_cuda.launches, mixer_cuda.bwd_launches, corr_cuda.launches)
        if got != (want_conv, want_fwd, DEPTH * c.I * steps, 0):
            fail(f"train loop to step {c.max_iters}: conv3x3_same, chan_ff_block, chan_ff_bwd and "
                 f"corr_sample launched {got} times, expected "
                 f"{(want_conv, want_fwd, DEPTH * c.I * steps, 0)}")
        main_path["conv3x3_same"] += got[0]
        main_path["chan_ff_block"] += got[1]
        main_path["chan_ff_bwd"] += got[2]
        losses = [float(v) for v in re.findall(r"loss = ([0-9.eE+-]+)", out)]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses + [*metrics.values()]):
            fail(f"train loop to step {c.max_iters}: {len(losses)} step losses, metrics {metrics}")
        return out, losses, secs, got

    out, losses, secs, got = loop_run(cfg, 0)
    head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log("loop", f"{LOOP_STEPS} steps (val, media, save every {LOOP_EVERY}) in {secs:.1f} s; "
                f"total_loss {' '.join(f'{v:.4g}' for v in losses)}; conv3x3_same, chan_ff_block, "
                f"chan_ff_bwd, corr_sample launches {got}")
    if not tail < head:
        fail(f"the train loop's loss did not fall: first three {head:.4g}, last three {tail:.4g}")
    if saverloader.list_steps(str(run_dir)) != [LOOP_STEPS]:
        fail(f"checkpoints {saverloader.list_steps(str(run_dir))}, expected [{LOOP_STEPS}]")
    (log_dir,) = (root / "logs").iterdir()
    with open(log_dir / "events.jsonl") as f:
        keys = {k for line in f for k in json.loads(line)}
    media = sorted(p.name for p in (log_dir / "media").iterdir())
    if not (any(k.startswith("pooled/") for k in keys)
            and any(k.startswith("val_pooled/") for k in keys)):
        fail(f"events.jsonl lacks pooled/ or val_pooled/ keys: {sorted(keys)}")
    if not (any("trajs_on_rgbs" in m for m in media) and any("fcp_point0" in m for m in media)):
        fail(f"no media written: {media}")
    out, more, secs, got = loop_run(dataclasses.replace(cfg, max_iters=LOOP_STEPS + LOOP_MORE),
                                    LOOP_STEPS)
    resumed = f"auto-resumed from {run_dir} at step {LOOP_STEPS}"
    if resumed not in out or saverloader.list_steps(str(run_dir)) != [LOOP_STEPS + LOOP_MORE]:
        fail(f"the relaunch did not resume at step {LOOP_STEPS}: {out[-2000:]}")
    log("loop", f"relaunch to step {LOOP_STEPS + LOOP_MORE}: {resumed}; total_loss "
                f"{' '.join(f'{v:.4g}' for v in more)}; {secs:.1f} s; launches {got}; media "
                f"{len(media)} files, events keys {len(keys)}; "
                f"phase {time.perf_counter() - t8:.1f} s")
    shutil.rmtree(root)

    # 7d. slice: the f32 train path with fused channel blocks, the f32
    # backward kernel's path
    zero_counts()
    train_f32 = phase_train_f32(torch, np, mixer_cuda, chanff_chunk_cuda, corr_cuda, build_dir)
    for k, n in train_f32.pop("launched").items():
        main_path[k] += n

    # 9. slice: the three profiling tools, the paths of the residual-block,
    # stem weight-gradient and chunked channel-block kernels
    zero_counts()
    main_path.update(phase_tools(torch, block_cuda, stem_wgrad_cuda, chanff_chunk_cuda))
    # ... and the three probe tools, the paths of the Mosaic probe kernels
    zero_counts()
    main_path.update(phase_probe_tools(torch))

    log("slice", f"main-path launches: {main_path}")
    if min(main_path.values()) == 0:
        fail(f"a kernel of the path never launched on it: {main_path}")
    print(smi, flush=True)  # again, so that the tail of the log holds the card and its limit
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
         "library_ms": None},
        {"name": "conv3x3_same", "route": "cuda", "source": "pips_tpu_torch/csrc/conv3x3_fwd.cu",
         "replaces": "pips_tpu/kernels/conv_pallas.py:148",
         "launches": main_path["conv3x3_same"], **conv["window"]},
        {"name": "res_block64", "route": "cuda", "source": "pips_tpu_torch/csrc/conv3x3_stats.cu",
         "replaces": "pips_tpu/kernels/block_pallas.py:110",
         "launches": main_path["res_block64"], **block["bench"]},
        {"name": "stem_wgrad", "route": "cuda", "source": "pips_tpu_torch/csrc/stem_wgrad.cu",
         "replaces": "pips_tpu/kernels/stem_wgrad_pallas.py:97",
         "launches": main_path["stem_wgrad"],
         **{k: v for k, v in stem["B=8"].items() if k != "x7_ms"}},
        {"name": "chan_ff_bwd_f32", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_bwd.cu",
         "replaces": "pips_tpu/kernels/mixer_pallas.py:245",
         "launches": main_path["chan_ff_bwd_f32"], **chanff_f32[TRAIN_R_DEFAULT],
         "library_ms": None},
        {"name": "chan_ff_chunked_fwd", "route": "cuda",
         "source": "pips_tpu_torch/csrc/chanff_chunk.cu",
         "replaces": "tools/profile_chanff_chunk.py:121",
         "launches": main_path["chan_ff_chunked_fwd"],
         **{k: v for k, v in chunk[("fwd", TRAIN_R, 512)].items() if k != "base_ms"},
         "library_ms": None},
        {"name": "chan_ff_chunked_bwd", "route": "cuda",
         "source": "pips_tpu_torch/csrc/chanff_chunk.cu",
         "replaces": "tools/profile_chanff_chunk.py:149",
         "launches": main_path["chan_ff_chunked_bwd"],
         **{k: v for k, v in chunk[("bwd", TRAIN_R, 512)].items() if k != "base_ms"},
         "library_ms": None}] + [
        {"name": name, "route": "cuda", "source": f"pips_tpu_torch/csrc/{source}.cu",
         "replaces": replaces, "launches": main_path[name], **probes[name]}
        for name, source, replaces in PROBE_KERNELS]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s "
                f"(chained video {chain_s:.2f} s; windows {json.dumps(window_ms)}; "
                f"training default {json.dumps(train_default)}; f32 {json.dumps(train_f32)})")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
