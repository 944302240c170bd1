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
     R=2048 and 2000, the training default's R=24,576 and R=100, which fills
     no whole row tile; bf16 also at the dense window's R=61,440, f32 at the
     f32 train path's R=1024; then at the Pips2 refiner's D=256, F=1024 at
     R=2048, 6144, 73,728 and 100 in both dtypes; two calls bit-identical, and
     one call per case, captured in a CUDA graph, the kernels of its launch
     plan, whose replay gives the same bits) and
     ``corr_sample`` (fused corr sampler, three point counts by three dtype
     pairs, then ``CORR_EDGES``: points all off the map, coords at +-1e8,
     N=1, a pyramid down to a 1x1 level; two calls bit-identical, and one
     kernel a call, captured in a CUDA graph); and ``chan_ff_bwd``
     (the channel block's backward, bf16, at the train shapes R=1024, 24,576,
     800 and 100, which fills no whole row tile, and at D=256, F=1024 at the
     Pips2 rows), all seven grads, two calls bit-identical, and one call,
     captured in a CUDA graph, the kernels of its launch plan, whose replay
     gives the same bits;
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
     full-width shapes (the stage-1 residual block at 8x64x192x256 bf16, and
     in f32: the f32 conv pass's path; the stem weight gradient at B=1 and
     B=8, 384x512 bf16, and in f32: the f32 kernel's path; a chain of 12
     channel blocks at R=1024, chunk widths 512 and 1024); ``res_block64`` must
     launch the conv-pass kernel 2 times per forward and 4 per
     forward+backward, ``stem_wgrad`` its kernel once per weight gradient,
     and the chunked chain 12 forward launches per chain forward and 12
     backward launches per chain backward;
 10. slice, Pips2 (PIPs++) at its class defaults (latent 128, 4 corr levels
     of radius 3, refiner 256 x 6), bf16, fused channel blocks (the kernels at
     D=256): (a) ``WindowTracker(corr_mode="onehot")``, 6 iterations, serves
     N=256 at 480x1024 at S=8 and S=24 with one set of weights, each window
     finite, frame 0 at the queries, 6 * 6 channel-block launches and within
     phase 4's drift bounds of the plain channel block; (b)
     ``ChainTracker(S=16)`` tracks phase 6's video; (c) one train step at S=24
     (the bench train shape otherwise) against the plain channel block at
     phase 7a's bounds; (d) ``train.loop.main`` with ``--model_family pips2
     --S 24`` for 12 steps with a validation pass and a checkpoint, the loss
     falling; (e) 2 timed steps at the loop's defaults (the refiner 512 x 12,
     S=24, N=768, both flips: the D=512 kernels at R=73,728; N halved while a
     step does not fit the card);
 11. slice, the data path: (a) the port's host library, built from its
     source, each C entry against its numpy form at 540x960; (b) a
     FlyingThings++ tree at 540x960 (TRAIN and TEST, 4 + 2 videos of 10
     webp frames, 20,000 points a window, occluders) and
     ``train.loop.main`` on it at the loop's defaults (full-width bf16
     Pips, fused channel blocks, augs on, N=768, S=8, I=4, 384x512; B=2,
     as B=4 does not fit the card) for 12 steps with a
     validation pass, media and a checkpoint; (c) a PointOdyssey tree
     (jpg, 540x960) and ``--model_family pips2 --dataset pointodyssey
     --S 24`` (B=1) for 6 steps; finite losses, a forward and a backward
     channel-block launch per block and iteration; host ms per sample,
     step ms and the loader waits printed.
 12. slice, the eval runners: seeded full-width weights written as a
     reference-format ``model-*.pth`` (``module.`` prefix), which
     ``evals.common.load_params`` must give back bit for bit; then
     ``pips_tpu_torch.evals.run_flt.main`` (FlyingThings++ TEST at 540x960,
     crop 384x512, N=16), ``run_crohd.main`` (HT21 at 1080x1920, stride 4),
     ``run_badja.main`` (a 20-frame 480x854 video resized to 320x512, chained
     at stride 4) and ``run_davis.main`` (two 8-frame 1080x1920 videos at
     480x1024, 7680 points, ``--chunk 0`` and ``256``), each with ``--dtype
     bfloat16``, ``run_flt`` also in f32: finite metrics, media written, 12 * 6
     ``chan_ff_block`` launches a window in bf16 and none in f32; the bf16
     trajectories against the plain channel block within the six-iteration
     drift bounds (DAVIS's dense ``trajs``, ``build_pips_tracker`` on the
     first FlyingThings++ and CroHD samples); each runner's seconds, median
     window ms and DAVIS's TPS printed.
 13. slice, the RAFT and DINO baselines (f32, no kernel of the port): (a)
     seeded full-width weights written as the release files (RAFT in
     ``raft-things.pth``'s layout: fnet 256, cnet 128+128, 4 levels of
     radius 4, ``module.`` prefixes; DINO ViT-S/8: dim 384, depth 12, 6
     heads, ``pos_embed`` on a 28x28 grid), which the port's loaders must
     put into its modules bit for bit; (b) one 8-frame window at 256x384,
     N=16, through ``build_baseline_tracker`` on the card and on the CPU:
     RAFT at 4 iterations and DINO within 1e-2 px, RAFT at 32 within the
     six-iteration drift bounds; (c) ``run_flt``, ``run_badja`` and
     ``run_crohd`` with ``--modeltype raft`` (32 iterations) and ``dino`` on
     phase 12's trees (FlyingThings++ 540x960 crop 384x512, BADJA's
     20-frame video at 320x512, CroHD 1080x1920 windows of S=8): finite
     metrics and media where the runner writes them; (d) none of the
     port's kernels launched; (e) each runner's seconds, first window,
     median of the rest and peak memory printed.
 14. slice, the last modules: (a) phase 12's seeded weights written as a
     JAX msgpack checkpoint (``model-*.msgpack`` of ``{"params": ...}``),
     which ``evals.common.load_params`` must give back bit for bit; (b)
     ``pips_tpu_torch.demo.main`` (2 chunks of 8 at 360x640, 16x16 points)
     and ``chain_demo.main`` (32 frames, 8x8 points) in its default,
     ``on_device`` and ``stream`` modes, all at ``--bf16 true`` from that
     checkpoint, on seeded noise jpgs at 540x960: GIFs written, every
     trajectory finite and at its query on frame 0, 12 * 6 ``chan_ff_block``
     launches a window, ``stream`` within 1e-3 px of the default and
     ``on_device`` within phase 6's bounds, seconds and points*frames/s; (c)
     ``parallel`` at world size 1 over NCCL: a sharded bf16 step at the bench
     train shape against the one-process step within 7a's bounds, both timed
     in turns, and ``run_davis --mesh auto`` on one video equal to ``--mesh
     ''``; (d) two ranks on the card over gloo, spawned here: at meshes
     (2, 1) and (1, 2), at one iteration (as 7d's exact f32 parity), an f32
     step (TF32 off) against the one-process step on the same global batch
     (B=2; loss within 1e-5 relative, gradient cosine at least 0.9999) and a
     bf16 step, no further from the one-process f32 step than the
     one-process bf16 step is (cosines within 0.01, loss within 0.2%), its
     7a comparison with the one-process bf16 step printed; each timed; a
     point-split f32 window at (1, 2) within 1e-3 px of the unsplit one at
     one iteration, within phase 4's drift bounds at six.
Phase 3 also holds (3d) ``conv3x3_same`` (the encoder's stage-1 3x3 conv)
against its plain version, forward and dx, at a window's, the training
default's and the bench train shape's stage 1 in bf16 and in f32 and a small
ragged shape in bf16 and f32, all channels_last, with dW and db through its
autograd Function, timed in turns with ``F.conv2d`` (full f32: TF32 off),
each f32 time beside the SIMT kernel's before the register-tiled redesign
(``F32_BEFORE_MS``); two calls bit-identical, and one forward and one dx call
each captured in a CUDA graph: one kernel, the one ``conv_cuda.launch_plan``
names (C = O = 64 bf16 the wgmma kernel, f32 ``conv3x3_f32``); and at
``CONV_WIDTHS`` (other widths, the mma.sync kernel) the same checks and
times; and phase 4 (4b)
serves the N=256 window with ``fuse_conv3``
against the same weights without it, 4 conv launches per window, in bf16
and in f32 (4 ``conv3x3_f32`` launches). 3e holds
``conv_pass`` (the residual block's conv with the norm statistics in its
epilogue), with and without its prologue, against its plain version and
against itself (two calls, the same bits) at the block's bench shape in bf16
and f32 and at a ragged shape in bf16 and f32, and the whole
``res_block64``, forward and five grads, against ``res_block64_reference``;
timed in turns with ``F.conv2d`` and the modular ``ResidualBlock``. 3f holds
``stem_wgrad`` against its plain version, and two calls against each other
(the same bits), at B=1 and B=8, 384x512 bf16 and f32, at B=2, 192x328 bf16
(each row's last segment of columns partial) and a small f32 shape, timed in
turns with the library's weight grad of the s2d conv and of the x7 conv. 3g holds
``chan_ff_bwd`` in f32 (the f32 kernels) at R=1024, 800, 100 and 24,576
and at D=256, F=1024 at the Pips2 rows against its plain version, all
seven grads, with matmuls in full f32 (TF32
off), repeats and kernel counts as in 3c. 3h holds the F-chunked channel block
(``chan_ff_block_chunked`` and ``chan_ff_chunked_bwd``) at R=1024, 800 and
100 (one ragged 64-row tile), bf16, against its plain versions at every chunk
width the kernels take (128, 256, 512, 1024), two calls bit-identical, and one
call of each pass, captured in a CUDA graph, the kernels of its
``chunk_plan`` (the forward one kernel), whose replay gives the same bits;
at the tool's 512 and 1024 also timed in turns with the monolithic kernels,
and at 512 at R=24,576; and in f32 at every one of those widths (the f32 chunked
block is the f32 monolithic block, so it launches ``chanff_fwd.cu``'s and
``chanff_bwd.cu``'s f32 kernels), with 3g's f32 bounds and TF32 off. 3i holds
the Mosaic probe kernels of the three probe tools against their plain
versions at the tools' shapes, and each against itself (two calls, the
same bits), each timed in turns with one library call where there is one
and with the launch floor (one PyTorch call on a one-element tensor),
beside its bound: ``gelu``, ``ln_slice`` and ``stream_accum``
(``tools/debug_mixer_kernel.py``, x (128, 4096) and w1 (12, 512, 2048)
bf16), ``corr_rows`` (``tools/debug_pallas7.py``, 8 points on a 16x128 map
of 128 f32 channels) and ``row_contract`` in the four layouts of
``tools/probe_mosaic_ops.py`` ((24, 256, 6) x (24, 256, 64) bf16); then
``stream_accum`` at 100 rows and five weight blocks, and ``row_contract`` at
three edge shapes (``CONTRACT_EDGES``), with one kernel a call counted in a
CUDA graph that captured the call. 3j holds the mixer's token half
(``token_mix_block``, ``csrc/token_ff.cu``) against ``token_mix_reference``
at N=1, 256, 7680 and 7681 points of S=8 tokens of D=512, bf16 element by
element and f32 (TF32 off), repeats and one kernel a call as in 3b, timed at
N=256 and 7680 (R=2048 and 61,440) beside the plain version and the bound;
the bf16 gate must refuse the kernel given a dropped or reversed b1 or b2,
and a CUDA call the kernel does not serve (autograd recording, S=16) must
raise; phases 4 and 5 hold every
served window to 72 token kernels and no plain call, phase 7 the default
train steps to no kernel and 48 plain calls a step at least (autograd
records). Phase 2 prints ptxas's registers and spills for the
kernels with asynchronous copy pipelines (``PTXAS_REPORT``). Phase 9
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
import copy
import dataclasses
import functools
import gc
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
import warnings
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
# phase 3b's edges, each with every dtype pair: (name, N, level-0 H, W, where
# the coords lie): every point off every level's map (4 px and more past the
# patch reach), coords at +-1e8 (and one NaN-free mix of both signs), one
# point, and a pyramid whose last level is 1x1
CORR_EDGES = [("off the map", 64, 60, 128, "off"), ("+-1e8", 64, 60, 128, "huge"),
              ("N=1", 1, 60, 128, "uniform"), ("1x1 level", 32, 8, 8, "uniform")]
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
DENSE_R = 1 * 7680 * 8  # the dense window's rows: N=7680 points x 8 frames
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
# shape (8 frames at 384x512), in bf16 and in f32 (``--dtype float32
# --fuse_conv3 1``); and a small shape with ragged tiles in bf16 and f32. All
# channels_last, as the encoder holds them and the kernel reads them.
CONV_SHAPES = [("window", 8, 240, 512, "bfloat16"),
               ("train default", 32, 184, 248, "bfloat16"),
               ("bench train", 8, 192, 256, "bfloat16"),
               ("small", 2, 31, 70, "bfloat16"),
               ("small f32", 2, 31, 70, "float32"),
               ("window f32", 8, 240, 512, "float32"),
               ("train default f32", 32, 184, 248, "float32"),
               ("bench train f32", 8, 192, 256, "float32")]
# widths other than 64 -> 64, which the earlier mma.sync kernel takes: the
# window's shape at 32 outputs, and a small ragged one at 24 -> 40
CONV_WIDTHS = [("window C=64 O=32", 8, 240, 512, 64, 32), ("small C=24 O=40", 2, 31, 70, 24, 40)]
CONV_PER_ENCODE = 4  # layer1_0.conv1/conv2 and layer1_1.conv1/conv2
LOOP_STEPS, LOOP_EVERY, LOOP_MORE = 12, 6, 6  # phase 8: steps, val/save/media period, relaunch
# phase 3e: the residual block's conv pass at the stage-1 bench shape of
# tools/profile_block_kernel.py (8 frames at 192x256, 64 channels, bf16) and a
# small shape whose H and W are no multiples of the kernels' tiles (4 x 30
# bf16, 8 x 32 f32: the last tiles hang over the border) in bf16 and f32; the
# whole block at the first
PASS_CASES = [("bench", 8, 192, 256, "bfloat16"), ("ragged bf16", 2, 31, 70, "bfloat16"),
              ("small f32", 2, 31, 70, "float32"), ("bench f32", 8, 192, 256, "float32")]
# the f32 kernels' times before the register-tiled redesign
# (csrc/conv3x3_f32_tiles.cuh), printed beside theirs: the earlier
# one-pixel-a-thread SIMT kernels (8 x 32 tiles, all 64 outputs a thread) at
# these cases, timed in turns with this design by
# ``python3 -m pips_tpu_torch.tools.profile_conv_f32 --against <that tree>``
# on an NVIDIA H100 80GB HBM3 at 700 W (ms; conv_pass with the prologue on)
F32_BEFORE_MS = {"conv3x3_f32": {"small f32": 0.1388, "window f32": 4.2631,
                                 "train default f32": 6.3482, "bench train f32": 1.7871},
                 "conv3x3_stats_f32": {"small f32": 0.1468, "bench f32": 1.8449}}
# phase 3i: row_contract off the probes' shapes: rows that fill no whole block
# (G=1, R=1000), b repeated over the batches (batch stride 0, G=3, R=100), and
# lanes off the fast path (CA=20, CB=24: the general branch)
CONTRACT_EDGES = [("R=1000", 1, 1000, 6, 64, False), ("G=3 R=100 b_bs=0", 3, 100, 6, 64, True),
                  ("CA=20 CB=24", 1, 1000, 20, 24, False)]
# phase 3f: the stem weight gradient at tools/profile_stem_wgrad.py's shapes
# in both dtypes, a bf16 one whose rows end in a partial segment of columns
# (Wo = 164 = 128 + 36, and 36 is no multiple of the kernel's 16-pixel steps)
# and a small one in f32 (Wo = 48: stem_wgrad_cuda.f32_plan cuts each row in
# two segments of 24 columns, six a pixel group)
STEM_CASES = [("B=1", 1, 384, 512, "bfloat16"), ("B=8", 8, 384, 512, "bfloat16"),
              ("ragged", 2, 192, 328, "bfloat16"), ("small f32", 2, 64, 96, "float32"),
              ("B=1 f32", 1, 384, 512, "float32"), ("B=8 f32", 8, 384, 512, "float32")]
U32 = 2.0 ** -24  # unit roundoff of f32
# phase 3j, the mixer's token half (csrc/token_ff.cu): one point, the served
# windows' N=256 (R=2,048), the dense window's N=7680 (R=61,440) and one point
# more; timed at the two windows' counts. f32 is held to its plain version
# within TOKEN_F32_REL of the output's largest magnitude (summation order over
# 8 and 32 terms, erff against PyTorch's erf), bf16 element by element
# (token_bf16_ratio); at TOKEN_FAULT_P points the bf16 gate must refuse the
# kernel given a dropped or reversed b1 or b2 (TOKEN_FAULTS)
TOKEN_POINTS = (1, 256, 7680, 7681)
TOKEN_FAULT_P = 256
TOKEN_FAULTS = (("b1 dropped", 4, "zero"), ("b2 dropped", 6, "zero"),
                ("b1 reversed", 4, "flip"), ("b2 reversed", 6, "flip"))
TOKEN_TIMED = (256, 7680)
TOKEN_F32_REL = 1e-5
EDGE_R = 100  # phases 3a, 3c and 3g: rows that fill no whole 128-row tile of the kernels
# the Pips2 (PIPs++) refiner's channel blocks (pips_tpu/models/pips2.py:111-121:
# 256 wide, F = 4 x 256) and their rows in phases 3a, 3c and 3g: an S=8 and an
# S=24 window of N=256 points, S=24 training (4 after both flips x 768 x 24) and
# a ragged tile
PIPS2_D, PIPS2_F = 256, 1024
PIPS2_RS = (1 * 256 * 8, 1 * 256 * 24, 4 * 768 * 24, EDGE_R)
# phase 10, Pips2 at its class defaults (latent 128, 4 levels of radius 3,
# refiner 256 x 6), bf16, fused channel blocks: windows of these lengths with
# one set of weights; a chain of S=16 windows; the bench train shape at S=24
# (the README's --S 24) for the parity step and train.loop.main; and timed
# steps at the loop's defaults (mixer_dim 512 x mixer_depth 12 as the refiner,
# S=24, N=768, both flips), N halved while a step does not fit the card
PIPS2_WINDOW_S = (8, 24)
PIPS2_CHAIN_S = 16
PIPS2_TRAIN = dict(TRAIN, S=24)
PIPS2_DEFAULT = dict(TRAIN_DEFAULT, S=24)
PIPS2_LOOP_DIMS = dict(refiner_dim=512, refiner_depth=12)
LOOP_PIPS2_STEPS = 12
# phase 11, the data path: FlyingThings++ at its published frame size, TRAIN
# and TEST splits of 10-frame videos (three S_load=8 windows each),
# trajectories and occluders laid out as tests/tests_treeutil.py lays out
# its small tree; enough points a clip (20,000, and 2,000 an occluder) that
# N=768 survive the crop and the twice-visible filter at most scales. Then a
# PointOdyssey tree at its frame size with sequences long enough for S=24
# windows. train.loop.main runs on each at the loop's defaults, only the
# location, the steps and the logging cadence set, and B: the default B=4
# (16 clips after both flips) does not fit an 80 GB card, nor does B=2 at
# S=24 (a first run of this phase: out of memory at B=4 for both sets and
# at B=2 for PointOdyssey, peak 55.5 GB at B=2 and 59.4 GB at B=1), so each
# starts at the largest B that fitted, halved again while a step does not
DATA_HW = (540, 960)
DATA_VIDEOS = {"TRAIN": 4, "TEST": 2}
DATA_FRAMES, DATA_S_LOAD = 10, 8
DATA_TRAJS, DATA_OCC_TRAJS = 20000, 2000
DATA_PO_FRAMES = {"train": 30, "val": 26}
DATA_PO_POINTS = 5000
LOOP_DATA_STEPS, LOOP_PO_STEPS = 12, 6
DATA_B = {"flyingthings": 2, "pointodyssey": 1}
DATA_HOST_SAMPLES = 2  # samples of each set timed on one host thread
# phase 12, the eval runners at the sets' own frame sizes, on the flagship's
# width with seeded weights written as a reference-format .pth (the module.
# prefix of a DataParallel model): FlyingThings++ TEST (phase 11's maker, 2
# videos of 3 windows at 540x960; crop 384x512, N=16: the runner's
# defaults), CroHD at HT21's 1080x1920 (four 24-frame windows of 24 heads
# moving 4 px a frame, 375 px from frame 0 summed over the 8 kept frames,
# where prep_sample keeps more than 150; 20 of them occluded in frames 12-14
# of a window, as the default req_occlusion keeps; stride 4), BADJA (a
# 20-frame video at 480x854, resized to 320x512; stride 4) and DAVIS (two
# 8-frame 1080x1920 videos, resized to 480x1024, 7680 points, --chunk 0 and
# 256). Every runner in bf16 (the kernel path), run_flt also in f32. A
# runner's first window runs at a shape no earlier phase ran (module loads,
# cuDNN plans, the allocator's growth): it is timed apart from the median of
# the rest, and DAVIS's steady TPS is its last video's.
EVAL_FLT_WINDOWS = 4
EVAL_CROHD_HW, EVAL_CROHD_WINDOWS, EVAL_CROHD_HEADS, EVAL_CROHD_OCCLUDED = (1080, 1920), 4, 24, 20
EVAL_BADJA_HW, EVAL_BADJA_T = (480, 854), 20
EVAL_DAVIS_HW, EVAL_DAVIS_VIDEOS, EVAL_DAVIS_CHUNKS = (1080, 1920), 2, (0, 256)
EVAL_DAVIS_POINTS = (480 // 8) * (1024 // 8)  # run_davis's dense grid at its defaults
# phase 13, the RAFT and DINO baselines: the card against the CPU on one
# 8-frame window (BASE_HW, BASE_N points), RAFT at these iterations (JAX's
# one-iteration bound for the first, the six-iteration drift bounds for the
# runners' default 32), DINO at BASE_PX; then the runners on phase 12's trees
# with CroHD cut to BASE_CROHD_WINDOWS of its 4 windows (a 1080x1920 window
# takes ~1.2 s with RAFT, ~8 s with DINO, whose f32 ViT attends over 32,400
# tokens)
BASE_HW, BASE_N, BASE_RAFT_ITERS, BASE_PX = (256, 384), 16, (4, 32), 1e-2
BASE_CROHD_WINDOWS = 2
# phase 14, the last modules: the demos on DEMO_FRAMES seeded noise jpgs at
# DEMO_HW (demo.py's DEMO_CHUNKS chunks of 8 at DEMO_RESIZE, its 360x640, and
# its 16x16 grid; chain_demo.py over all the frames on a DEMO_CHAIN_GRID^2
# grid), at --bf16 true from a JAX msgpack checkpoint of phase 12's seeded
# weights; parallel/ at world size 1 over NCCL, and two ranks on the card over
# gloo: MESH_TRAIN (one sample a rank on the data axis) at MESH_SHAPES, the
# MESH_STEPS; a point-split f32 window at MESH_WINDOW_HW
DEMO_HW, DEMO_RESIZE, DEMO_FRAMES, DEMO_CHUNKS, DEMO_CHAIN_GRID = (540, 960), (360, 640), 32, 2, 8
MESH_TRAIN = dict(TRAIN, B=2)
MESH_SHAPES = ((2, 1), (1, 2))
MESH_F32 = dict(loss_rel=1e-5, global_cos=0.9999)
# (dtype, iterations) of the two-rank steps, at one iteration: at six untrained
# weights amplify the order of summation that the split changes (the chaos
# policy of docs/TESTING.md; 7d holds f32 at one iteration for the same
# reason). f32 within MESH_F32 of the one-process step; bf16 within PARITY of
# the one-process step at the ranks' shapes: at (1, 2) the one-process step,
# at (2, 1) ``split_step``, the same B=1 halves in one process with no
# collective (bf16 rounds a B=1 step otherwise than a B=2 step, which the
# smoke measures beside it)
MESH_STEPS = (("float32", 1), ("bfloat16", 1))
MESH_WINDOW_HW = (480, 1024)
MESH_CHILD_TIMEOUT_S = 300
CHUNK_FCS = (512, 1024)  # phase 3h times these: tools/profile_chanff_chunk.py's chunk widths
# phase 3h's rows: the tool's, a ragged R and one ragged 64-row tile; and the
# chunk width it also times at the training default's R=24,576
CHUNK_RS = (TRAIN_R, 800, EDGE_R)
CHUNK_FC_LARGE = 512
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


# kernels whose registers and spills the build report prints (ptxas -v)
PTXAS_REPORT = [("stem_wgrad", "stem_wgrad_tc"), ("mixer_probes", "probe_stream_accum"),
                ("conv3x3_stats", "conv3x3_stats_bf16"), ("row_contract", "row_contract_tc"),
                ("chanff_bwd", "chanff_bwd_act"), ("chanff_bwd", "chanff_bwd_dxa"),
                ("chanff_bwd", "chanff_bwd_wgrad"), ("chanff_fwd", "chanff_fwd_act"),
                ("chanff_fwd", "chanff_fwd_out"), ("chanff_fwd", "chanff_fwd_act_f32"),
                ("chanff_fwd", "chanff_fwd_out_f32"), ("chanff_chunk", "chanff_chunk_fwd"),
                ("chanff_chunk", "chanff_chunk_bwd_rows"), ("conv3x3_fwd", "conv3x3_wgmma"),
                ("corr_sample_fwd", "corr_sample_points"), ("conv3x3_fwd", "conv3x3_f32"),
                ("conv3x3_stats", "conv3x3_stats_f32"), ("stem_wgrad", "stem_wgrad_f32"),
                ("token_ff", "token_ff_bf16"), ("token_ff", "token_ff_f32")]
# of those, the kernels whose report must show no spills
NO_SPILLS = ("conv3x3_wgmma", "corr_sample_points", "conv3x3_f32", "conv3x3_stats_f32",
             "stem_wgrad_f32", "token_ff_bf16", "token_ff_f32")


def ptxas_report(log_path: Path, kernel: str) -> str:
    """The registers, stack and spill lines that ptxas -v printed for the
    entry function named ``kernel`` (its mangled name holds the name after
    its length, so ``chanff_bwd_act`` is not ``chanff_bwd_act_f32``)."""
    found, lines = False, []
    for line in log_path.read_text(errors="replace").splitlines():
        if "Compiling entry function" in line:
            found = f"{len(kernel)}{kernel}" in line
        elif found and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    if not lines:
        fail(f"the build log {log_path} has no ptxas report for {kernel}")
    return "; ".join(lines)


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


def corr_args(torch, np, N: int, H8: int, W8: int, map_dt: str, tgt_dt: str, seed: int,
              where: str = "uniform"):
    """A 4-level pyramid of random (1, 8, H8, W8, 128) maps built by the port,
    targets, and coords (level-0 scale): ``uniform`` over the map and 4 px
    beyond every side; ``off``, every point at least 4 px past the reach of
    every level's patch (8 * 2^3 px past the level-0 map, on every side);
    ``huge``, at +-1e8."""
    from pips_tpu_torch.ops.corr import build_fmap_pyramid

    rng = np.random.RandomState(seed)
    fm = torch.from_numpy(rng.randn(1, 8, H8, W8, CORR_C).astype(np.float32))
    pyramid = [p.contiguous() for p in
               build_fmap_pyramid(fm.to("cuda", getattr(torch, map_dt)), 4)]
    targets = torch.from_numpy(rng.randn(1, 8, N, CORR_C).astype(np.float32))
    coords = np.stack([rng.uniform(-4, W8 + 3, (1, 8, N)), rng.uniform(-4, H8 + 3, (1, 8, N))],
                      axis=-1)
    if where == "off":  # each point past one side, chosen at random, by 96 to 200 px
        side = rng.randint(0, 4, (1, 8, N))
        far = rng.uniform(96, 200, (1, 8, N))
        coords[..., 0] = np.where(side == 0, -far, np.where(side == 1, W8 + far, coords[..., 0]))
        coords[..., 1] = np.where(side == 2, -far, np.where(side == 3, H8 + far, coords[..., 1]))
    elif where == "huge":
        coords = np.sign(rng.randn(1, 8, N, 2)) * 1e8
    coords = coords.astype(np.float32)
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


def conv_args(torch, np, B: int, H: int, W: int, dtype: str, seed: int, C: int = 64,
              O: int = 64):
    """x (B, C, H, W) in dtype and channels_last, an f32 weight (O, C, 3, 3)
    and bias as the encoder holds them, and dy (B, O, H, W) for the backward."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(B, C, H, W), rng.randn(O, C, 3, 3) * np.sqrt(2.0 / (9 * C)),
            0.1 * rng.randn(O), rng.randn(B, O, H, W)]
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
    prologue, and against itself (two calls give the same bits), then the
    whole ``res_block64`` forward and five grads against
    ``res_block64_reference``, with times in turns with the library."""
    from pips_tpu_torch.models.encoder import ResidualBlock

    out = {}
    for case, B, H, W, dtype in PASS_CASES:
        x, w, b, aff = pass_args(torch, np, B, H, W, dtype, seed=B + H)
        parts, errs = [], []
        for prologue in (False, True):
            y, st = block_cuda.conv_pass(x, w, b, aff, prologue)
            y2, st2 = block_cuda.conv_pass(x, w, b, aff, prologue)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(st, st2)):  # no atomics, fixed orders
                fail(f"conv_pass {case} prologue={prologue}: two calls on the same input differ")
            del y2, st2
            y_ref, st_ref = block_cuda.conv_pass_reference(x, w, b, aff, prologue)
            tol_acc, tol_st = pass_tols(torch, F, x, w, b, aff, prologue,
                                        block_cuda.stats_tiles(H, W, x.dtype))
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
        before = F32_BEFORE_MS["conv3x3_stats_f32"].get(case)
        log("kernels", f"conv_pass {case} {B}x64x{H}x{W} {dtype} channels_last: "
                       + "; ".join(parts) + f"; prologue on {k1:.4f}/{k2:.4f} ms, F.conv2d "
                       f"{l1:.4f}/{l2:.4f} ms (in turns), prologue off {k0:.4f} ms, plain "
                       f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                       + (f", the SIMT kernel before {before:.4f} ms" if before else ""))
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
    """3f: ``stem_wgrad`` against its plain version (and against itself: two
    calls give the same bits), timed in turns with the library's weight grad
    of the s2d conv and of the x7 conv."""
    out = {}
    for case, B, H, W, dtype in STEM_CASES:
        x2, dy = stem_args(torch, np, B, H, W, dtype, seed=B + H)
        dk = stem_cuda.stem_wgrad(x2, dy)
        again = stem_cuda.stem_wgrad(x2, dy)
        torch.cuda.synchronize()
        if not torch.equal(dk, again):  # partials added in a fixed order, no atomics
            fail(f"stem_wgrad {case}: two calls on the same input differ")
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

        plan = ("" if dtype != "float32" else
                f"{stem_cuda.f32_plan(B, dy.shape[2], dy.shape[3], stem_cuda._sms(0))}, ")
        k1 = median_ms(torch, stem_cuda.stem_wgrad, (x2, dy))
        l1 = median_ms(torch, library, ())
        x1 = median_ms(torch, library_x7, ())
        k2 = median_ms(torch, stem_cuda.stem_wgrad, (x2, dy))
        l2 = median_ms(torch, library, ())
        x7_2 = median_ms(torch, library_x7, ())
        plain_ms = median_ms(torch, stem_cuda.stem_wgrad_reference, (x2, dy), launches=3)
        bound_ms, bound_by = stem_bound(x2, dy, dtype)
        log("kernels", f"stem_wgrad {case} x2 {tuple(x2.shape)} dy {tuple(dy.shape)} {dtype} "
                       f"channels_last: {plan}max_abs_err {err:.3g} (tol {tol:.3g}, |dk| <= "
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


def captured_kernels(torch, fn) -> tuple:
    """The device kernels one call of ``fn`` enqueues, in launch order, and
    the call's output: the call is captured into a CUDA graph, whose kernel
    nodes the driver lists (``cudaGraphDebugDotPrint``), and the graph is
    replayed once so that the output is what those kernels computed. Each
    name is its node's label: the kernel's name with its launch shape."""
    try:  # keep the captured graph past its instantiation, where the build offers that
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        g = torch.cuda.CUDAGraph()
    g.enable_debug_mode()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        out = fn()
    if hasattr(g, "instantiate"):
        g.instantiate()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_", dir=build) as tmp:
        dot = Path(tmp) / "graph.dot"
        with warnings.catch_warnings():  # the dump announces itself as a debugging aid
            warnings.simplefilter("ignore", UserWarning)
            g.debug_dump(str(dot))
        if not dot.exists():
            fail(f"torch {torch.__version__} wrote no dump of the captured graph")
        text = dot.read_text()
    g.replay()
    torch.cuda.synchronize()
    del g
    starts = list(re.finditer(r'"graph_\d+_node_(\d+)"\s*\[', text))
    nodes = sorted((int(m.group(1)), text[m.end():(starts[i + 1].start() if i + 1 < len(starts)
                                                    else len(text))])
                   for i, m in enumerate(starts))
    kernels = [label for _, label in nodes if "KERNEL" in label]
    if not kernels:
        fail(f"the captured graph lists no kernel node: {text[:2000]!r}")
    return kernels, out


def names_kernel(label: str, name: str) -> bool:
    """Whether a graph node's ``label`` is the kernel ``name``, mangled (the
    name behind its length) or demangled (followed by its arguments or
    template arguments)."""
    return f"{len(name)}{name}" in label or re.search(re.escape(name) + r"(?=\(|\\?<)",
                                                      label) is not None


def one_kernel_call(torch, fn, args, out, kernel: str, label: str) -> None:
    """``fn(*args)`` called again gives ``out``'s bits, and one call, captured
    in a CUDA graph, is one kernel, ``kernel``, whose replay gives them too;
    fails otherwise."""
    again = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        fail(f"{label}: two calls on the same inputs differ")
    kernels, replayed = captured_kernels(torch, lambda: fn(*args))
    if len(kernels) != 1 or not names_kernel(kernels[0], kernel):
        fail(f"{label}: one call launched {kernels}, not one {kernel}")
    if not torch.equal(replayed, out):
        fail(f"{label}: the captured call's replay differs from the call")


def bwd_repeat(torch, mixer_cuda, args, out, label: str) -> None:
    """``chan_ff_bwd`` called again on the same inputs gives the same bits in
    all seven grads; fails otherwise."""
    again = mixer_cuda.chan_ff_bwd(*args)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(GRAD_NAMES, out, again) if not torch.equal(a, b)]
    if differ:
        fail(f"{label}: two calls on the same inputs differ in {differ}")


def bwd_launches_match_plans(torch, mixer_cuda, cases: dict, label: str) -> None:
    """Each call ``chan_ff_bwd(*args)`` of ``cases`` (R -> args) enqueues the
    kernels of its plan (``mixer_cuda.bwd_plan``) in its order, no more, as a
    CUDA graph that captured the call lists them, and the graph's replay gives
    the bits of an eager call in all seven grads; fails otherwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for R, args in cases.items():
        x, w1 = args[0], args[4]
        plan = mixer_cuda.bwd_plan(R, w1.shape[1], x.dtype, sms, x.shape[1])
        suffix = "_f32" if x.dtype == torch.float32 else ""
        want = [f"chanff_bwd_{k}{suffix if k in ('act', 'dxa', 'wgrad') else ''}"
                for k in plan.grids]
        eager = mixer_cuda.chan_ff_bwd(*args)
        labels, replayed = captured_kernels(torch, lambda: mixer_cuda.chan_ff_bwd(*args))
        if len(labels) != len(want) or not all(map(names_kernel, labels, want)):
            fail(f"{label} R={R}: one call enqueued {len(labels)} kernels, its plan {want}: "
                 f"{labels}")
        differ = [n for n, a, b in zip(GRAD_NAMES, eager, replayed) if not torch.equal(a, b)]
        if differ:
            fail(f"{label} R={R}: the captured call's replay differs from an eager call in "
                 f"{differ}")
        log("kernels", f"{label} R={R} captured: {len(labels)} kernels a call "
                       f"({', '.join(want)}), split {plan.split}; its replay bit-identical")
        del eager, replayed
    torch.cuda.empty_cache()


def fwd_launches_match_plans(torch, mixer_cuda, cases: dict, label: str) -> None:
    """Each call ``chan_ff_block(*args)`` of ``cases`` ((dtype, R) -> args)
    enqueues the kernels of its plan (``mixer_cuda.fwd_plan``) in its order,
    no more, as a CUDA graph that captured the call lists them, and the
    graph's replay gives the bits of an eager call; fails otherwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (dtype, R), args in cases.items():
        x, w1 = args[0], args[3]
        plan = mixer_cuda.fwd_plan(R, w1.shape[1], x.dtype, sms, x.shape[1])
        suffix = "_f32" if x.dtype == torch.float32 else ""
        want = [f"chanff_fwd_{k}{suffix if k in ('act', 'out') else ''}" for k in plan.grids]
        eager = mixer_cuda.chan_ff_block(*args)
        labels, replayed = captured_kernels(torch, lambda: mixer_cuda.chan_ff_block(*args))
        if len(labels) != len(want) or not all(map(names_kernel, labels, want)):
            fail(f"{label} {dtype} R={R}: one call enqueued {len(labels)} kernels, its plan "
                 f"{want}: {labels}")
        if not torch.equal(eager, replayed):
            fail(f"{label} {dtype} R={R}: the captured call's replay differs from an eager call")
        log("kernels", f"{label} {dtype} R={R} captured: {len(labels)} kernels a call "
                       f"({', '.join(want)}), split {plan.split}; its replay bit-identical")
        del eager, replayed
    torch.cuda.empty_cache()


def token_args(torch, np, P: int, dtype: str, seed: int, S: int = 8, D: int = 512,
               H: int = 32) -> list:
    """x (P, S, D) in ``dtype``, tokens of unequal scale, and the token
    half's f32 parameters as the modules store them, on the card."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(P, S, D) * (1 + 2 * rng.rand(P, S, 1)), 1.0 + 0.1 * rng.randn(D),
            0.1 * rng.randn(D), rng.randn(S, H) / np.sqrt(S), 0.1 * rng.randn(H),
            rng.randn(H, S) / np.sqrt(H), 0.1 * rng.randn(S)]
    out = [torch.from_numpy(v.astype(np.float32)).to("cuda") for v in vals]
    out[0] = out[0].to(getattr(torch, dtype))
    return out


def token_bound(P: int, dtype: str, S: int = 8, D: int = 512, H: int = 32):
    """The token block's least time on the card, the larger of x read and y
    written once over HBM and the two products' operations over the dtype's
    peak, with the bound's name; and its exact-erf GELUs, the ALU work the
    roofline leaves out."""
    nbytes = 2 * P * S * D * (2 if dtype == "bfloat16" else 4)
    flops = 2 * 2 * P * D * S * H
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", P * D * H


def token_bf16_ratio(torch, token_cuda, args, y, ref) -> float:
    """The largest |y - ref| in bf16 over its own element's bound: 2^-6 of
    the FF term's magnitude there, (|h| + |b1|) @ |w2| + |b2| with h = LN(x)
    w1 in f32 (the plain version rounds h, its bias, the GELU, the second
    product and b2 to bf16, the kernel only the GELU), plus 2^-7 |ref| for
    the two roundings of y, each at most half an ulp. The residual x, which
    sets the largest |y|, widens no other element's bound."""
    x, scale, bias, w1, b1, w2, b2 = args
    xa = token_cuda.layer_norm(x, scale, bias).to(x.dtype).float()
    h = xa.transpose(1, 2) @ w1.to(x.dtype).float()
    ff = ((h.abs() + b1.abs()) @ w2.to(x.dtype).float().abs()).transpose(1, 2)
    tol = 2.0 ** -6 * (ff + b2.abs()[None, :, None]) + 2.0 ** -7 * ref.float().abs()
    return ((y.float() - ref.float()).abs() / tol).max().item()


def phase_token(torch, np, token_cuda) -> dict:
    """3j: ``token_mix_block`` (``csrc/token_ff.cu``) against
    ``token_mix_reference`` at ``TOKEN_POINTS`` points of S=8 tokens of
    D=512 channels, in bf16 (element by element, ``token_bf16_ratio``) and
    f32 (within ``TOKEN_F32_REL`` of the largest magnitude, TF32 off): a
    repeat gives the same bits, one call, captured in a CUDA graph, is one
    kernel, and no call takes the plain version; at ``TOKEN_TIMED`` timed
    beside the plain version and the bound. The bf16 gate must refuse the
    kernel given a faulty bias (``TOKEN_FAULTS``), and the block must raise
    on a CUDA call the kernel does not serve. Keyed by (dtype, points)."""
    require_full_f32(torch)
    out = {}
    args = token_args(torch, np, TOKEN_FAULT_P, "bfloat16", seed=5)
    ref = token_cuda.token_mix_reference(*args)
    for name, i, fault in TOKEN_FAULTS:
        bad = list(args)
        bad[i] = torch.zeros_like(args[i]) if fault == "zero" else args[i].flip(0)
        ratio = token_bf16_ratio(torch, token_cuda, args, token_cuda.token_mix_block(*bad), ref)
        if not ratio > 1.0:
            fail(f"the token block's bf16 gate passes the kernel given {name}: {ratio:.3g} <= 1")
        log("kernels", f"token_mix_block bf16 gate: the kernel given {name} reads {ratio:.3g} "
                       f"of its bound (refused)")
    refused = {"autograd recording": args[:2] + [args[2].clone().requires_grad_(True)] + args[3:],
               "S=16": token_args(torch, np, 4, "bfloat16", seed=6, S=16, H=64)}
    for name, call in refused.items():
        try:
            with torch.enable_grad():
                token_cuda.token_mix_block(*call)
        except ValueError:
            continue
        fail(f"token_mix_block on the card did not raise at {name}")
    log("kernels", f"token_mix_block raises on the card at {', '.join(refused)}")
    del args, ref, bad, refused
    for dtype in ("bfloat16", "float32"):
        for P in TOKEN_POINTS:
            args = token_args(torch, np, P, dtype, seed=P + 11)
            plain_before = token_cuda.plain_calls
            y = token_cuda.token_mix_block(*args)
            torch.cuda.synchronize()
            ref = token_cuda.token_mix_reference(*args)
            err = (y.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            if dtype == "bfloat16":
                ratio = token_bf16_ratio(torch, token_cuda, args, y, ref)
            else:
                ratio = err / (TOKEN_F32_REL * ref_max)
            label = f"token_mix_block {dtype} N={P} (R={P * 8})"
            if not (y.shape == ref.shape and y.dtype == ref.dtype and ratio <= 1.0):
                fail(f"{label} disagrees with its plain version: {ratio:.3g} of its bound "
                     f"(max_abs_err {err})")
            kernel = "token_ff_bf16" if dtype == "bfloat16" else "token_ff_f32"
            one_kernel_call(torch, token_cuda.token_mix_block, args, y, kernel, label)
            if token_cuda.plain_calls != plain_before:
                fail(f"{label}: took the plain version on the card")
            msg = (f"{label}: max_abs_err {err:.3g} ({ratio:.3g} of its bound, |y| <= "
                   f"{ref_max:.3g}); repeat bit-identical, one {kernel} a call")
            res = dict(max_abs_err=err, bound_ratio=ratio)
            if P in TOKEN_TIMED:
                ms = median_ms(torch, token_cuda.token_mix_block, args, launches=20)
                plain_ms = median_ms(torch, token_cuda.token_mix_reference, args, launches=5)
                bound_ms, bound_by, erfs = token_bound(P, dtype)
                msg += (f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                        f"({bound_by}), {erfs / 1e6:.1f} M exact-erf GELUs")
                res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
            log("kernels", msg)
            out[(dtype, P)] = res
            del args, y, ref
    torch.cuda.empty_cache()
    return out


def phase_chanff_f32(torch, np, mixer_cuda) -> dict:
    """3g: ``chan_ff_bwd`` in f32 (the f32 kernels of ``csrc/chanff_bwd.cu``)
    against its plain version at the bench train shape, a ragged R, an edge R
    that fills no whole row tile and the training default, then at the Pips2
    refiner's D=256, F=1024 (``PIPS2_RS``), all seven grads, with its time
    and bound; a repeat must give the same bits, and one call launch its
    plan's kernels. Keyed by (R, D)."""
    require_full_f32(torch)
    out = {}
    for D, F_, rows in ((512, 2048, (TRAIN_R, 800, EDGE_R, TRAIN_R_DEFAULT)),
                        (PIPS2_D, PIPS2_F, PIPS2_RS)):
        cases = {}
        for R in rows:
            args = chanff_bwd_args(torch, np, R, seed=R + 3, D=D, F=F_, dtype=torch.float32)
            before = mixer_cuda.bwd_f32_launches, mixer_cuda.bwd_launches
            got = mixer_cuda.chan_ff_bwd(*args)
            torch.cuda.synchronize()
            if (mixer_cuda.bwd_f32_launches, mixer_cuda.bwd_launches) != (before[0] + 1,
                                                                          before[1]):
                fail(f"chan_ff_bwd f32 D={D} R={R} did not launch the f32 kernels once")
            ref = mixer_cuda.chan_ff_bwd_reference(*args)
            tols = chanff_bwd_tols(torch, mixer_cuda, args)
            label = f"chan_ff_bwd f32 D={D} R={R}"
            worst, parts, max_err = grad_errors(torch, label, got, ref, tols)
            bwd_repeat(torch, mixer_cuda, args, got, label)
            parts.append("repeat bit-identical")
            n = 20 if R < TRAIN_R_DEFAULT else 5
            ms = median_ms(torch, mixer_cuda.chan_ff_bwd, args, launches=n)
            plain_ms = median_ms(torch, mixer_cuda.chan_ff_bwd_reference, args, launches=n)
            bound_ms, bound_by = chanff_bwd_bound(R, "float32", D, F_)
            log("kernels", f"chan_ff_bwd f32 D={D} F={F_} R={R}: max_abs_err " + "; ".join(parts)
                           + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                             f"({bound_by})")
            if worst > 1.0:
                fail(f"{label} disagrees with its plain version (worst err/tol {worst:.3g})")
            out[(R, D)] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
            cases[R] = args
            del got, ref, tols
        bwd_launches_match_plans(torch, mixer_cuda, cases, f"chan_ff_bwd f32 D={D}")
        del cases
        torch.cuda.empty_cache()
    return out


def chunk_call_checks(torch, chunk_cuda, fargs, bargs, fc: int, label: str) -> str:
    """One chunked forward and one backward call at (R, fc): each repeated
    gives the same bits; each, captured in a CUDA graph, enqueues exactly the
    kernels of its ``chunk_plan`` in its order (the forward one kernel), and
    the graph's replay gives the bits of an eager call; the plan's clusters
    fit the card at once (``cudaOccupancyMaxActiveClusters``). Fails
    otherwise; returns a summary."""
    R, F = fargs[0].shape[0], fargs[3].shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = chunk_cuda.chunk_plan(R, F, fc, sms)
    fwd = functools.partial(chunk_cuda.chan_ff_block_chunked, *fargs, fc=fc)
    bwd = functools.partial(chunk_cuda.chan_ff_chunked_bwd, *bargs, fc=fc)
    y, y2 = fwd(), fwd()
    g, g2 = bwd(), bwd()
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(GRAD_NAMES, g, g2) if not torch.equal(a, b)]
    if not torch.equal(y, y2) or differ:
        fail(f"{label}: two calls on the same inputs differ (forward {not torch.equal(y, y2)}, "
             f"backward {differ})")
    for name, call, want, eager in (("forward", fwd, plan.fwd.kernels, y),
                                    ("backward", bwd, plan.bwd.kernels, g)):
        labels, replayed = captured_kernels(torch, call)
        if len(labels) != len(want) or not all(map(names_kernel, labels, want)):
            fail(f"{label} {name}: one call enqueued {len(labels)} kernels, its plan {list(want)}: "
                 f"{labels}")
        same = (torch.equal(eager, replayed) if name == "forward"
                else all(torch.equal(a, b) for a, b in zip(eager, replayed)))
        if not same:
            fail(f"{label} {name}: the captured call's replay differs from an eager call")
    for backward, p in ((0, plan.fwd), (1, plan.bwd)):
        fits = chunk_cuda.max_clusters(backward, p.split) if p.split > 1 else None
        if fits is not None and p.grid[1] > fits:
            fail(f"{label}: {p.grid[1]} clusters of {p.split} blocks, the card holds {fits} "
                 "at once")
    return (f"repeats bit-identical; captured {len(plan.fwd.kernels)} + {len(plan.bwd.kernels)} "
            f"kernels ({', '.join(plan.fwd.kernels + plan.bwd.kernels)}), replays bit-identical; "
            f"grid {plan.fwd.grid}, clusters of {plan.fwd.split}")


def phase_chunk(torch, np, chunk_cuda, mixer_cuda) -> dict:
    """3h: the F-chunked channel block (``csrc/chanff_chunk.cu``), forward and
    backward, bf16, at the tool's R=1024, a ragged R and one ragged row tile
    (R=100), against its plain versions at every chunk width the kernels
    take, each call repeated for the same bits and counted in a captured CUDA
    graph against ``chunk_plan``; at the tool's widths (R=1024 and 800) also
    timed in turns with the monolithic kernels on the same inputs, and at
    fc=512 at the training default's R=24,576."""
    out = {}
    for R in CHUNK_RS + (TRAIN_R_DEFAULT,):
        fargs = chanff_args(torch, np, R, torch.bfloat16, seed=R + 5)
        bargs = chanff_bwd_args(torch, np, R, seed=R + 6)
        tols = chanff_bwd_tols(torch, mixer_cuda, bargs)
        timed = {TRAIN_R: CHUNK_FCS, 800: CHUNK_FCS, TRAIN_R_DEFAULT: (CHUNK_FC_LARGE,)}.get(R, ())
        for fc in (chunk_cuda.FCS if R in CHUNK_RS else timed):
            y = chunk_cuda.chan_ff_block_chunked(*fargs, fc=fc)
            grads = chunk_cuda.chan_ff_chunked_bwd(*bargs, fc=fc)
            torch.cuda.synchronize()
            ref = chunk_cuda.chan_ff_chunked_reference(*fargs, fc=fc)
            err = (y.float() - ref.float()).abs().max().item()
            tol = bf16_tol(ref.float().abs().max().item())
            gref = chunk_cuda.chan_ff_chunked_bwd_reference(*bargs, fc=fc)
            worst, parts, max_err = grad_errors(torch, f"chan_ff_chunked_bwd R={R} fc={fc}",
                                                grads, gref, tols)
            like = y.shape == ref.shape and y.dtype == ref.dtype
            del grads, ref, gref
            calls = chunk_call_checks(torch, chunk_cuda, fargs, bargs, fc,
                                      f"chunked block R={R} fc={fc}")
            log("kernels", f"chunked block R={R} fc={fc} bf16: forward max_abs_err {err:.3g} "
                           f"(tol {tol:.3g}); backward " + "; ".join(parts) + f"; {calls}")
            if not (like and err <= tol):
                fail(f"chan_ff_block_chunked R={R} fc={fc} disagrees with its plain version: "
                     f"{err} > {tol}")
            if worst > 1.0:
                fail(f"chan_ff_chunked_bwd R={R} fc={fc} disagrees with its plain version (worst "
                     f"err/tol {worst:.3g})")
            del y
            if fc not in timed:
                continue

            fwd = functools.partial(chunk_cuda.chan_ff_block_chunked, fc=fc)
            bwd = functools.partial(chunk_cuda.chan_ff_chunked_bwd, fc=fc)
            n = 20 if R < TRAIN_R_DEFAULT else 5
            t = {k: [] for k in ("fwd", "base fwd", "bwd", "base bwd")}
            for _ in range(2):
                t["fwd"].append(median_ms(torch, fwd, fargs, launches=n))
                t["base fwd"].append(median_ms(torch, mixer_cuda.chan_ff_block, fargs, launches=n))
                t["bwd"].append(median_ms(torch, bwd, bargs, launches=n))
                t["base bwd"].append(median_ms(torch, mixer_cuda.chan_ff_bwd, bargs, launches=n))
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
    (``pips_tpu_torch/tools/_probes.py``), and against themselves (two calls
    give the same bits); each timed in turns with the library call that
    computes the same function where there is one, beside its plain version
    and its bound; then ``stream_accum`` at ragged rows and five weight
    blocks. Returns the kernels line's numbers by entry name."""
    from pips_tpu_torch.kernels import corr_rows_cuda, mixer_probes_cuda
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
    # the launch floor: one PyTorch call on a one-element tensor, timed in
    # turns with each probe as the probe and its library call are
    one = torch.zeros(1, device="cuda")

    def floor():
        return torch.neg(one)

    out, floors = {}, []
    for probe, p in probes.items():
        entry, library, nbytes, ops, dtype = meta[probe]
        got = p.kernel()
        again = p.kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, again):  # fixed summation orders, no atomics
            fail(f"3i: {entry} ({probe}): two calls on the same input differ")
        try:
            err, worst = _probes.check(probe, got, p.plain(),
                                       None if p.terms is None else p.terms(),
                                       None if p.slack is None else p.slack())
        except RuntimeError as e:
            fail(f"3i: {e}")
        # kernel and library in turns
        k1 = median_ms(torch, p.kernel, ())
        l1 = None if library is None else median_ms(torch, library, ())
        f1 = median_ms(torch, floor, ())
        k2 = median_ms(torch, p.kernel, ())
        l2 = None if library is None else median_ms(torch, library, ())
        f2 = median_ms(torch, floor, ())
        floors += [f1, f2]
        ms, lib_ms = (k1 + k2) / 2, None if library is None else (l1 + l2) / 2
        plain_ms = median_ms(torch, p.plain, ())
        bound_ms, bound_by = probe_bound(nbytes, ops, dtype)
        lib = "none" if library is None else f"{l1:.4f}/{l2:.4f} ms"
        log("kernels", f"{entry} ({probe}): max_abs_err {err:.3g} (worst err/tol {worst:.3g}); "
                       f"{k1:.4f}/{k2:.4f} ms, library {lib}, launch floor {f1:.4f}/{f2:.4f} "
                       f"ms (in turns), plain "
                       f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
                       f"{nbytes / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP)")
        out[entry] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms)
    floors.sort()
    log("kernels", f"launch floor (torch.neg of a one-element tensor, in turns with the probes): "
                   f"median {floors[len(floors) // 2]:.4f} ms, {floors[0]:.4f}-{floors[-1]:.4f} "
                   f"over {len(floors)} timings")
    del x, w1, a_cat, w_cat, fmap, targets, coords, a, b, probes, one
    # stream_accum's tiles at their edges: 100 rows (a ragged row tile), five
    # weight blocks (a quarter of K is 10 stages), x wider than the slice
    g = torch.Generator(device="cuda").manual_seed(11)
    xr = torch.randn(100, 1024, device="cuda", generator=g).to(torch.bfloat16)
    wr = (torch.randn(5, 512, 2048, device="cuda", generator=g) * 0.02).to(torch.bfloat16)
    got = mixer_probes_cuda.stream_accum(xr, wr)
    again = mixer_probes_cuda.stream_accum(xr, wr)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("3i: stream_accum M=100 NB=5: two calls on the same input differ")
    try:
        err, worst = _probes.check("stream_accum M=100 NB=5", got,
                                   mixer_probes_cuda.stream_accum_reference(xr, wr),
                                   mixer_probes_cuda.stream_accum_reference(xr.abs(), wr.abs()))
    except RuntimeError as e:
        fail(f"3i: {e}")
    log("kernels", f"stream_accum M=100 NB=5 x {tuple(xr.shape)} w1 {tuple(wr.shape)}: "
                   f"max_abs_err {err:.3g} (worst err/tol {worst:.3g}); "
                   f"{median_ms(torch, mixer_probes_cuda.stream_accum, (xr, wr)):.4f} ms")
    del xr, wr, got, again
    phase_contract_edges(torch)
    torch.cuda.empty_cache()
    return out


def phase_contract_edges(torch) -> None:
    """3i, ``row_contract`` off the probes' shapes (``CONTRACT_EDGES``):
    against its plain version with the probes' tolerance, against itself (the
    same bits), and captured in a CUDA graph: one kernel a call, as at each
    probe's shape, whose replay gives the same bits."""
    from pips_tpu_torch.kernels import row_contract_cuda
    from pips_tpu_torch.tools import _probes, probe_mosaic_ops

    g = torch.Generator(device="cuda").manual_seed(12)
    edges = {}
    for label, G, R, CA, CB, b_batch0 in CONTRACT_EDGES:
        a = (torch.rand(G, R, CA, device="cuda", generator=g) - 0.5).to(torch.bfloat16)
        b = (torch.rand(1 if b_batch0 else G, R, CB, device="cuda", generator=g)
             - 0.5).to(torch.bfloat16)
        edges[label] = (a, b.expand(G, R, CB))
    for label, (a, b) in edges.items():
        got = row_contract_cuda.row_contract(a, b, probe="edge")
        again = row_contract_cuda.row_contract(a, b, probe="edge")
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"3i: row_contract {label}: two calls on the same input differ")
        try:
            err, worst = _probes.check(f"row_contract {label}", got,
                                       row_contract_cuda.row_contract_reference(a, b),
                                       row_contract_cuda.row_contract_reference(a.abs(), b.abs()))
        except RuntimeError as e:
            fail(f"3i: {e}")
        plan = row_contract_cuda.launch_plan(*a.shape, b.shape[2], a.stride()[:2], b.stride()[:2])
        log("kernels", f"row_contract {label} a {tuple(a.shape)} {a.stride()} b "
                       f"{tuple(b.shape)} {b.stride()}: {plan}; max_abs_err {err:.3g} "
                       f"(worst err/tol {worst:.3g}); "
                       f"{median_ms(torch, row_contract_cuda.row_contract, (a, b)):.4f} ms")
    # the kernels each call enqueues, as a CUDA graph that captured it lists them
    a0, b0 = probe_mosaic_ops.inputs("cuda")
    calls = [lambda a=a, b=b: row_contract_cuda.row_contract(a, b, probe="edge")
             for a, b in edges.values()]
    calls += [lambda f=f: f(a0, b0) for f in (probe_mosaic_ops.probe_a, probe_mosaic_ops.probe_c)]
    counts = []
    for call in calls:
        eager = call()
        labels, replayed = captured_kernels(torch, call)
        counts.append(len(labels))
        if len(labels) != 1 or not any(names_kernel(labels[0], k)
                                       for k in ("row_contract_tc", "row_contract_simt")):
            fail(f"3i: one row_contract call enqueued {len(labels)} kernels: {labels}")
        if not torch.equal(eager, replayed):
            fail("3i: a captured row_contract call's replay differs from an eager call")
    log("kernels", f"row_contract captured: {sum(counts)} kernels for {len(calls)} calls (the "
                   f"edges, probes A and C), one a call; each replay bit-identical")


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
    block_cuda.launches = 0  # the f32 block: the f32 conv pass (csrc/conv3x3_stats.cu)
    t = time.perf_counter()
    res = profile_block_kernel.main(dtype="float32")
    n_block32 = block_cuda.launches
    log("tools", f"profile_block_kernel.main(dtype='float32') in {time.perf_counter() - t:.1f} s: "
                 f"{json.dumps(res)}; {n_block32} f32 conv_pass launches (expected {want})")
    if n_block32 != want or not all(math.isfinite(v) and v > 0 for v in res.values()):
        fail(f"profile_block_kernel f32: {n_block32} launches, expected {want}; {res}")
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
    stem_cuda.launches = 0  # the f32 kernel (csrc/stem_wgrad.cu: stem_wgrad_f32)
    t = time.perf_counter()
    res_s = profile_stem_wgrad.main(dtype="float32")
    n_stem32 = stem_cuda.launches
    log("tools", f"profile_stem_wgrad.main(dtype='float32') in {time.perf_counter() - t:.1f} s: "
                 f"{json.dumps(res_s)}; {n_stem32} f32 stem_wgrad launches (expected {want})")
    if n_stem32 != want or not all(math.isfinite(v) for r in res_s.values() for v in r.values()):
        fail(f"profile_stem_wgrad f32: {n_stem32} launches, expected {want}; {res_s}")
    # against cuDNN's weight grad in full f32 (TF32 off): both sum K products
    # of magnitude at most 1/4 in their own orders, held to 4 u K m as 3f
    for (B, H, W), r in zip(profile_stem_wgrad.SHAPES, res_s.values()):
        if r["err"] > 4 * U32 * B * (H // 2) * (W // 2) * 0.25:
            fail(f"profile_stem_wgrad f32 B={B}: dk differs from the library's: {r}")
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
    return {"res_block64": n_block, "res_block64_f32": n_block32, "stem_wgrad": n_stem,
            "stem_wgrad_f32": n_stem32,
            "chan_ff_chunked_fwd": got[0], "chan_ff_chunked_bwd": got[1]}


def train_batch(torch, np, cfg: dict, seed: int) -> dict:
    """A batch of ``cfg["B"]`` synthetic samples of ``cfg.get("S", 8)`` frames on the card."""
    from pips_tpu_torch.data import SyntheticPointDataset

    ds = SyntheticPointDataset(S=cfg.get("S", 8), N=cfg["N"], H=cfg["H"], W=cfg["W"], seed=seed)
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


def step_launches(torch, dtype, iters: int, steps: int = 1, depth: int = DEPTH) -> tuple:
    """``train_counts`` of ``steps`` train steps at ``iters`` refinement
    iterations: ``depth`` (the mixer's 12, Pips2's refiner blocks)
    channel-block forwards and as many backwards in the model's dtype per
    iteration, no corr kernel (Pips trains through onehot, Pips2 full)."""
    n = depth * iters * steps
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


def split_step(torch, model, batch, iters: int, parts: int = 2):
    """What the ``parts`` ranks of a (parts, 1) mesh compute, done in one
    process with no collective: each slice of B runs the loss with every
    masked mean's denominator summed over the slices (counted first in a pass
    without grads), and the slices' grads and metrics are summed. The
    (metrics, grads in f32) of ``loss_and_grads``; nothing applied, no flips."""
    from pips_tpu_torch.ops.reduce import denominators_summed
    from pips_tpu_torch.train import train_loss_fn

    B = batch["rgbs"].shape[0]
    parts = [{k: v[i * B // parts:(i + 1) * B // parts] for k, v in batch.items()}
             for i in range(parts)]
    counts = []
    for part in parts:
        seen = []
        with torch.no_grad(), denominators_summed(lambda c: seen.append(c.clone()) or c):
            train_loss_fn(model, part, iters)
        counts.append(seen)
    if len({len(c) for c in counts}) != 1:
        fail(f"split step: the slices took {[len(c) for c in counts]} masked means")
    totals = [sum(cs) for cs in zip(*counts)]
    model.zero_grad(set_to_none=True)
    metrics = {}
    for part in parts:
        it = iter(totals)
        with denominators_summed(lambda c: next(it)):
            total, met = train_loss_fn(model, part, iters)
        total.backward()  # each slice's grads add to the others'
        for k, v in met.items():
            metrics[k] = metrics.get(k, 0.0) + float(v.detach())
    torch.cuda.synchronize()
    out = (metrics, {n: p.grad.detach().float().clone() for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return out


def encode_split_diff(torch, model, rgbs) -> float:
    """How far the encoder's features of sample 0 move when it is encoded
    alone instead of in the whole batch, relative to their largest value."""
    with torch.no_grad():
        whole = model.encode(rgbs)[:1].float()
        alone = model.encode(rgbs[:1]).float()
    return float((whole - alone).abs().max() / whole.abs().max())


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
                phase: str, witness=None, cfg: dict = TRAIN, depth: int = DEPTH) -> tuple:
    """(a) of phases 7, 7d and 10: one step's loss and grads at the bench train
    shape (``cfg``, Pips2's at S=24) with ``iters`` refinement iterations and
    ``depth`` channel blocks an iteration, the kernels against the plain
    channel block (forward and backward). Fails on a launch count, or past
    ``bounds`` (``grad_parity``'s keys: ``loss_rel`` at most, each cosine at
    least). ``witness``, a (forward, backward) pair, runs a third step through
    another plain version of the block, held against the plain step and
    printed, not bounded: the reading of how far summation order alone moves
    the step. Returns the kernels' ``train_counts``."""
    zero_train_counts(mixer_cuda, corr_cuda)
    k = loss_and_grads(torch, model, batch, cfg, iters)
    got, want = train_counts(mixer_cuda, corr_cuda), step_launches(torch, dtype, iters, 1, depth)
    if got != want:
        fail(f"{phase} parity step I={iters}: {TRAIN_KERNELS} launched {got} times, "
             f"expected {want}")

    def plain_step(forward, backward):
        with channel_blocks_as(mixer_cuda, forward, backward):
            zero_train_counts(mixer_cuda, corr_cuda)
            out = loss_and_grads(torch, model, batch, cfg, iters)
            if any(train_counts(mixer_cuda, corr_cuda)):
                fail(f"the plain channel block launched kernels: "
                     f"{train_counts(mixer_cuda, corr_cuda)}")
        return out

    p = plain_step(mixer_cuda.chan_ff_reference, mixer_cuda.chan_ff_bwd_reference)
    r = grad_parity(torch, k, p)
    (km, _), (pm, _) = k, p
    msg = (f"parity step (B={cfg['B']} S={cfg.get('S', 8)} N={cfg['N']} I={iters} "
           f"{cfg['H']}x{cfg['W']}, "
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


def timed_steps(torch, mixer_cuda, corr_cuda, model, batch, dtype, n: int, phase: str,
                cfg: dict = TRAIN_DEFAULT, depth: int = DEPTH):
    """(c) of phases 7, 7d and 10: a warm-up and ``n`` timed train steps at the
    training default (``cfg``; both flips) (host clock around each
    synchronised step), each with its launches (``depth`` channel blocks an
    iteration) checked and finite metrics. Returns the median step ms,
    points*frames/s and peak memory, and the launches of all ``n + 1``."""
    from pips_tpu_torch.train import make_optimizer, make_train_step

    opt = make_optimizer(model.parameters(), lr=5e-4, num_steps=100)
    step = make_train_step(model, opt, iters=cfg["iters"], horz_flip=True, vert_flip=True)
    want = step_launches(torch, dtype, cfg["iters"], 1, depth)
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
    c, S = cfg, cfg.get("S", 8)
    pf = 4 * c["N"] * S / med_s
    log(phase, f"training default (B={c['B']} x4 flips, S={S}, N={c['N']}, I={c['iters']}, "
               f"{c['H']}x{c['W']}, {str(dtype).split('.')[-1]}): steps "
               f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, median {med_s * 1e3:.1f} ms; "
               f"{pf:.0f} points*frames/s (4 x {c['N']} x {S} per step); "
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


def pips2_model(torch, train: bool = False, **dims):
    """A bf16 Pips2 with fused channel blocks at its class defaults (or
    ``dims``), parameters from ``init_params(0)``, on the card."""
    from pips_tpu_torch import Pips2, init_params

    model = init_params(Pips2(dtype=torch.bfloat16, fuse_chanff=True, **dims), 0).to("cuda")
    return model.train() if train else model.eval()


def phase_pips2(torch, np, mixer_cuda, corr_cuda, build_dir: Path) -> dict:
    """10: the Pips2 (PIPs++) family at its class defaults, bf16, its channel
    blocks the kernels at D=256, F=1024: (a) ``WindowTracker`` (onehot, six
    iterations) serves N=256 at 480x1024 with one set of weights at S=8 and
    S=24, each window finite, frame 0 at the queries, 6 * 6 channel-block
    launches, and within the phase-4 drift bounds of the plain channel block;
    (b) ``ChainTracker(S=16)`` tracks phase 6's video; (c) one train step at
    S=24 against the plain block at phase 7a's bounds; (d)
    ``train.loop.main --model_family pips2 --S 24`` for 12 steps with a
    validation pass and a checkpoint, the loss falling; (e) timed steps at the
    loop's defaults (refiner 512 x 12, S=24, N=768, both flips; the D=512
    kernels at R=73,728). Returns the launches and the numbers."""
    from pips_tpu_torch import ChainTracker, WindowTracker, grid_queries
    from pips_tpu_torch.models import pips2 as pips2_module
    from pips_tpu_torch.train import parse_cli
    from pips_tpu_torch.train import loop as train_loop
    from pips_tpu_torch.utils import saverloader

    bf16 = torch.bfloat16
    launched, numbers = {"chan_ff_block": 0, "chan_ff_bwd": 0}, {}
    model = pips2_model(torch)
    depth = model.refiner.depth
    log("pips2", f"bf16 Pips2 (refiner {model.refiner.embed.kernel.shape[1]} x {depth}) on cuda "
                 f"({sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params)")

    # (a) windows of two lengths, one set of weights
    tracker = WindowTracker(model, iters=ITERS, corr_mode="onehot")
    tracker1 = WindowTracker(model, iters=1, corr_mode="onehot")
    rng = np.random.RandomState(2)
    H, W, N = 480, 1024, 256
    xys = (rng.rand(1, N, 2) * [W - 8, H - 8] + 4).astype(np.float32)
    for S in PIPS2_WINDOW_S:
        name = f"Pips2 S={S} N={N} @{H}x{W}"
        rgbs = (rng.rand(1, S, H, W, 3) * 255).astype(np.float32)
        mixer_cuda.launches = corr_cuda.launches = 0
        trajs, vis = tracker(xys, rgbs)
        n_ff, n_corr = mixer_cuda.launches, corr_cuda.launches
        check_window(np, name, trajs, vis, xys, S=S)
        if n_ff != depth * ITERS or n_corr:
            fail(f"{name}: chan_ff_block launched {n_ff} and corr_sample {n_corr} times, "
                 f"expected {depth * ITERS} and 0")
        launched["chan_ff_block"] += n_ff
        k1 = tracker1(xys, rgbs)
        with plain_channel_blocks(pips2_module, mixer_cuda.chan_ff_reference):
            p1 = tracker1(xys, rgbs)
            p6 = tracker(xys, rgbs)
        one, six = drift(np, *k1, *p1), drift(np, trajs, vis, *p6)
        times = sorted(window_seconds(torch, tracker, xys, rgbs) for _ in range(5))
        numbers[f"window S={S} ms"] = times[2] * 1e3
        log("pips2", f"{name}: {n_ff} chan_ff launches; moved up to "
                     f"{np.abs(trajs - xys[:, None]).max():.1f} px; vs plain block: 1 iter traj "
                     f"max {one['max']:.3g} px, vis max {one['vis_max']:.3g}; 6 iters {fmt(six)}; "
                     f"median window over 5 {times[2] * 1e3:.2f} ms "
                     f"({N * S / times[2]:.0f} points*frames/s, host clock)")
        check_drift(name, one, six)
    torch.cuda.empty_cache()

    # (b) a chain of S=16 windows over phase 6's video
    T, Hc, Wc = 32, 360, 640
    video = (np.random.RandomState(1).rand(T, Hc, Wc, 3) * 255).astype(np.float32)
    qs = grid_queries(Hc, Wc)[0]
    chain = ChainTracker(model, iters=ITERS, corr_mode="onehot", capacity=256, S=PIPS2_CHAIN_S)
    calls = [0]
    track = chain.tracker.track

    def counted_track(*a, **k):
        calls[0] += 1
        return track(*a, **k)

    chain.tracker.track = counted_track
    mixer_cuda.launches = corr_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    ct, cv = chain.track_video(video, qs)
    secs = time.perf_counter() - t
    n_ff = mixer_cuda.launches
    if ct.shape != (T, qs.shape[0], 2) or cv.shape != (T, qs.shape[0]):
        fail(f"Pips2 chain: shapes {ct.shape}, {cv.shape}")
    if not (np.isfinite(ct).all() and np.isfinite(cv).all() and np.array_equal(ct[0], qs)
            and cv.min() >= 0.0 and cv.max() <= 1.0):
        fail("Pips2 chain: non-finite output, frame 0 off the queries or vis outside [0, 1]")
    if n_ff != depth * ITERS * calls[0] or corr_cuda.launches:
        fail(f"Pips2 chain: {calls[0]} tracker calls launched chan_ff_block {n_ff} times")
    launched["chan_ff_block"] += n_ff
    numbers["chain s"] = secs
    log("pips2", f"ChainTracker(S={chain.S}) T={T} {Hc}x{Wc} N={qs.shape[0]}: {calls[0]} tracker "
                 f"calls, {n_ff} chan_ff launches; {secs:.3f} s wall, "
                 f"{T * qs.shape[0] / secs:.0f} points*frames/s; moved up to "
                 f"{np.abs(ct - qs[None]).max():.1f} px")
    del model, tracker, tracker1, chain
    torch.cuda.empty_cache()

    # (c) one train step at S=24 against the plain channel block
    model = pips2_model(torch, train=True)
    batch = train_batch(torch, np, PIPS2_TRAIN, seed=0)
    got = parity_step(torch, mixer_cuda, corr_cuda, model, batch, bf16, PIPS2_TRAIN["iters"],
                      PARITY, "pips2", cfg=PIPS2_TRAIN, depth=depth)
    launched["chan_ff_block"] += got[0]
    launched["chan_ff_bwd"] += got[1]
    del model, batch
    torch.cuda.empty_cache()

    # (d) the loop's own entry point at S=24, the refiner at its 256 x 6
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pips2_", dir=build_dir))
    c = PIPS2_TRAIN
    argv = ["--model_family", "pips2", "--dataset", "synthetic", "--S", str(c["S"]),
            "--mixer_dim", str(PIPS2_D), "--mixer_depth", str(depth), "--B", str(c["B"]),
            "--N", str(c["N"]), "--I", str(c["iters"]), "--crop_size", f"{c['H']},{c['W']}",
            "--horz_flip", "false", "--vert_flip", "false",
            "--max_iters", str(LOOP_PIPS2_STEPS), "--save_freq", str(LOOP_PIPS2_STEPS),
            "--val_freq", str(LOOP_PIPS2_STEPS), "--val_batches", "1",
            "--log_freq", str(LOOP_PIPS2_STEPS), "--log_media", "false", "--metrics_every", "1",
            "--num_workers", "4", "--ckpt_dir", str(root / "ckpts"), "--log_dir",
            str(root / "logs")]
    cfg = parse_cli(argv)
    zero_train_counts(mixer_cuda, corr_cuda)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = train_loop.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    want = (depth * cfg.I * (LOOP_PIPS2_STEPS + cfg.val_batches), depth * cfg.I * LOOP_PIPS2_STEPS,
            0, 0)
    got = train_counts(mixer_cuda, corr_cuda)
    if got != want:
        fail(f"the Pips2 loop: {TRAIN_KERNELS} launched {got} times, expected {want}")
    launched["chan_ff_block"] += got[0]
    launched["chan_ff_bwd"] += got[1]
    losses = [float(v) for v in re.findall(r"loss = ([0-9.eE+-]+)", buf.getvalue())]
    if len(losses) != LOOP_PIPS2_STEPS or not all(math.isfinite(v)
                                                  for v in losses + [*metrics.values()]):
        fail(f"the Pips2 loop: {len(losses)} step losses, metrics {metrics}")
    head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    steps_saved = saverloader.list_steps(str(root / "ckpts" / cfg.model_name()))
    numbers["loop s"] = secs
    log("pips2", f"train.loop.main({' '.join(argv[:6])} ...): {LOOP_PIPS2_STEPS} steps, a "
                 f"validation pass and a checkpoint in {secs:.1f} s; total_loss "
                 f"{' '.join(f'{v:.4g}' for v in losses)} (ce {metrics['ce']:.3g}); checkpoints "
                 f"{steps_saved}; launches {got}")
    if not tail < head:
        fail(f"the Pips2 loop's loss did not fall: first three {head:.4g}, last three {tail:.4g}")
    if steps_saved != [LOOP_PIPS2_STEPS]:
        fail(f"the Pips2 loop's checkpoints are {steps_saved}, expected [{LOOP_PIPS2_STEPS}]")
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    # (e) timed steps at the loop's defaults, N halved until a step fits the card
    model = pips2_model(torch, train=True, **PIPS2_LOOP_DIMS)
    c = dict(PIPS2_DEFAULT)
    while True:
        big = train_batch(torch, np, c, seed=1)
        try:
            timed, got = timed_steps(torch, mixer_cuda, corr_cuda, model, big, bf16, 2, "pips2",
                                     cfg=c, depth=PIPS2_LOOP_DIMS["refiner_depth"])
            break
        except torch.cuda.OutOfMemoryError:
            del big
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            log("pips2", f"a step at N={c['N']} does not fit the card: halving N")
            c["N"] //= 2
            if c["N"] < 96:
                fail("no Pips2 step at the loop's defaults fits the card")
    launched["chan_ff_block"] += got[0]
    launched["chan_ff_bwd"] += got[1]
    numbers.update({f"default {k}": v for k, v in timed.items()}, default_N=c["N"])
    log("pips2", f"timed at refiner {PIPS2_LOOP_DIMS['refiner_dim']} x "
                 f"{PIPS2_LOOP_DIMS['refiner_depth']}, S={c['S']}, N={c['N']} (asked 768), "
                 f"rows {4 * c['N'] * c['S']} a channel block")
    del model, big
    torch.cuda.empty_cache()
    return dict(launched=launched, **numbers)


def write_pfm(np, path: Path, data) -> None:
    """A little-endian one-channel PFM, rows bottom-up (tests/tests_treeutil.py's)."""
    h, w = data.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n" + f"{w} {h}\n".encode() + b"-1.0\n")
        f.write(np.flipud(data).astype("<f4").tobytes())


def data_frame(np, rng, H: int, W: int):
    """A uint8 frame of 8x8 blocks of random colour plus pixel noise: the
    decoders and the photometric augs get texture, the encoder stays fast."""
    coarse = rng.randint(0, 256, (H // 8 + 1, W // 8 + 1, 3)).astype(np.int16)
    img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
    return np.clip(img + rng.randint(-6, 7, img.shape), 0, 255).astype(np.uint8)


def save_frames(frames) -> None:
    """Encode (path, array) pairs in parallel: webp lossless (the method that
    encodes fastest; the pixels are the same), else jpg."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def save(item):
        path, img = item
        kw = dict(lossless=True, method=0, quality=0) if path.suffix == ".webp" else {}
        Image.fromarray(img).save(path, **kw)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, frames))


def make_flyingthings_tree(np, root: Path, videos: dict = DATA_VIDEOS) -> None:
    """FlyingThings++ at ``DATA_HW``, ``videos[split]`` videos a split: per
    video 10 webp frames, object-index PFMs (a background and two moving
    boxes, ids 1 and 2), three trajectory windows of ``DATA_TRAJS`` static
    points and three occluder files of object 1's ``DATA_OCC_TRAJS`` points."""
    H, W = DATA_HW
    rng = np.random.RandomState(11)
    frames = []
    for dset, n in videos.items():
        for v in range(n):
            folder = f"{v:07d}"
            dirs = {k: root / k / dset / "A" / folder / "left"
                    for k in ("frames_cleanpass_webp", "object_index", "trajs_ad", "occluders_al")}
            for d in dirs.values():
                d.mkdir(parents=True)
            boxes = [(rng.randint(0, H - h - 20), rng.randint(0, W - w - 30), h, w)
                     for h, w in ((H * 3 // 8, W * 5 // 16), (H * 2 // 9, W * 3 // 16))]
            for fr in range(DATA_FRAMES):
                frames.append((dirs["frames_cleanpass_webp"] / f"{fr:04d}.webp",
                               data_frame(np, rng, H, W)))
                mask = np.zeros((H, W), np.float32)
                for oid, (y, x, h, w) in enumerate(boxes, start=1):
                    y, x = min(y + 2 * fr, H - h), min(x + 3 * fr, W - w)
                    mask[y:y + h, x:x + w] = oid
                write_pfm(np, dirs["object_index"] / f"{fr:04d}.pfm", mask)
            y, x, h, w = boxes[0]
            for k in range(3):
                pts = rng.rand(DATA_TRAJS, 2) * [W - 2, H - 2]
                np.savez(dirs["trajs_ad"] / f"trajs_at_{k}.npz",
                         trajs=np.tile(pts[None], (DATA_S_LOAD, 1, 1)).astype(np.float16))
                occ = rng.rand(DATA_OCC_TRAJS, 2) * [w, h] + [x, y]
                np.save(dirs["occluders_al"] / f"occluder_at_{k}.npy",
                        {"1": np.tile(occ[None], (DATA_S_LOAD, 1, 1)).astype(np.float16)},
                        allow_pickle=True)
    save_frames(frames)


def make_pointodyssey_tree(np, root: Path) -> None:
    """PointOdyssey at ``DATA_HW``: one train and one val sequence of jpg
    frames, ``DATA_PO_POINTS`` random-walk trajectories, 90% visible."""
    H, W = DATA_HW
    rng = np.random.RandomState(12)
    frames = []
    for split, T in DATA_PO_FRAMES.items():
        seq = root / split / "seq0"
        (seq / "rgbs").mkdir(parents=True)
        for fr in range(T):
            frames.append((seq / "rgbs" / f"rgb_{fr + 1:05d}.jpg", data_frame(np, rng, H, W)))
        start = rng.rand(DATA_PO_POINTS, 2) * [W - 40, H - 40] + 20
        walk = np.cumsum(rng.randn(T, DATA_PO_POINTS, 2), axis=0)
        np.savez(seq / "annotations.npz", trajs_2d=(start + walk).astype(np.float32),
                 visibilities=(rng.rand(T, DATA_PO_POINTS) < 0.9).astype(np.float32))
    save_frames(frames)


def phase_host_lib(np) -> dict:
    """11a: build the port's host library from its source, then hold each C
    entry against its numpy form at FlyingThings' frame size; one call each,
    timed on the host clock. Returns {entry: (C ms, numpy ms)}."""
    import tempfile as _tempfile

    from pips_tpu_torch.data.augs import gaussian_taps
    from pips_tpu_torch.native import lib

    t = time.perf_counter()
    path = lib.library_path()
    lib.ensure_built(force=True)
    log("data", f"host library built from {lib.SOURCE.name} in {time.perf_counter() - t:.2f} s "
                f"-> {path}; version {lib._load().pips_native_version()}")
    H, W = DATA_HW
    rng = np.random.RandomState(13)
    img = data_frame(np, rng, H, W)
    f32 = img.astype(np.float32)
    N = DATA_TRAJS
    pts = (rng.rand(N, 2) * [W + 40, H + 40] - 20).astype(np.float32)
    pts[np.abs(pts - np.round(pts)) == 0.5] += 0.125  # chain_step rounds halves otherwise
    flow = rng.randn(H, W, 2).astype(np.float32)
    occ = np.where(rng.rand(H, W) < 0.2, 255.0, 0.0).astype(np.float32)
    painter = rng.randint(0, 5, (H, W)).astype(np.uint8)
    birth = rng.randint(0, 5, N).astype(np.int32)
    rects = np.array([[x, x + 60, y, y + 40] for x, y in rng.randint(0, 800, (10, 2))], np.int32)
    M = np.full((3, 4), 0.02)
    M[:, 3] = -11.0
    M[np.arange(3), np.arange(3)] += 1.13
    taps = gaussian_taps(11, 1.7)
    pfm = (b"Pf\n" + f"{W} {H}\n".encode() + b"-1.0\n"
           + np.flipud(flow[..., 0]).astype("<f4").tobytes())
    alt = np.ascontiguousarray(f32[::-1])
    mask = rng.rand(1, H, W).astype(np.float32)

    def vis_pass(fn):
        vis, inb = np.ones(N, np.float32), np.empty(N, np.uint8)
        fn(pts, occ, vis, inb)
        return vis, inb

    def covered(fn):
        vis = np.ones(N, np.float32)
        fn(painter, pts, birth, vis)
        return vis

    def rects_in(fn):
        vis = np.ones(N, np.float32)
        fn(pts, rects, vis)
        return vis

    cases = {
        "decode_pfm": (lambda: lib.decode_pfm(pfm), lambda: lib.decode_pfm_reference(pfm)),
        "composite": (lambda: lib.composite(f32[None].copy(), alt[None], mask),
                      lambda: lib.composite_reference(f32[None].copy(), alt[None], mask)),
        "resize_bilinear": (lambda: lib.resize_bilinear(f32, (384, 512)),
                            lambda: lib.resize_bilinear_reference(f32, (384, 512))),
        "chain_step": (lambda: lib.chain_step(flow, pts.copy()),
                       lambda: lib.chain_step_reference(flow, pts.copy())),
        "mark_in_rects": (lambda: rects_in(lib.mark_in_rects),
                          lambda: rects_in(lib.mark_in_rects_reference)),
        "mark_covered_frame": (lambda: covered(lib.mark_covered_frame),
                               lambda: covered(lib.mark_covered_frame_reference)),
        "visibility_frame": (lambda: vis_pass(lib.visibility_frame),
                             lambda: vis_pass(lib.visibility_frame_reference)),
        "color_affine": (lambda: lib.color_affine(img, M),
                         lambda: lib.color_affine_reference(img, M)),
        "hue_shift": (lambda: lib.hue_shift(img, -17), lambda: lib.hue_shift_reference(img, -17)),
        "gaussian_blur": (lambda: lib.gaussian_blur(img, taps),
                          lambda: lib.gaussian_blur_reference(img, taps)),
    }
    with _tempfile.NamedTemporaryFile(suffix=".pfm") as f:
        f.write(pfm)
        f.flush()
        cases["decode_pfm_file"] = (lambda: lib.decode_pfm_file(f.name),
                                    lambda: lib.decode_pfm_reference(pfm))
        times = {}
        for name, (c_fn, np_fn) in cases.items():
            c_fn()
            t = time.perf_counter()
            got = c_fn()
            c_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            want = np_fn()
            np_ms = (time.perf_counter() - t) * 1e3
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if g.shape != w.shape or not np.array_equal(g, w):
                    fail(f"host library {name}: the C entry differs from its numpy form")
            times[name] = (c_ms, np_ms)
    per_entry = ", ".join(f"{k} {c:.2f} / {n:.1f}" for k, (c, n) in times.items())
    log("data", f"host library at {H}x{W} ({N} points): every C entry equals its numpy form; "
                f"C / numpy ms {per_entry}")
    return times


def host_ms_per_sample(ds) -> list:
    """Host ms of ``DATA_HOST_SAMPLES`` samples on one thread (the first
    decodes its frames cold; later ones may hit the frame caches)."""
    out = []
    for i in range(DATA_HOST_SAMPLES):
        t = time.perf_counter()
        ds[i * 7919]
        out.append((time.perf_counter() - t) * 1e3)
    return out


def data_loop(torch, mixer_cuda, corr_cuda, argv: list, steps: int, depth: int,
              label: str) -> dict:
    """``train.loop.main(argv)`` at ``DATA_B[label]``, halved while a step
    does not fit the card. Asserts finite losses, a checkpoint at the last step
    and the channel-block kernels' launches (a forward per block and
    iteration of every step, validation batch and media render, a backward
    per block and iteration of every step). Returns the numbers."""
    from pips_tpu_torch.train import parse_cli
    from pips_tpu_torch.train import loop as train_loop
    from pips_tpu_torch.utils import saverloader

    B = DATA_B[label]
    while True:
        args = argv + ["--B", str(B)]
        cfg = parse_cli(args)
        zero_train_counts(mixer_cuda, corr_cuda)
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                metrics = train_loop.main(args)
            torch.cuda.synchronize()
            break
        except RuntimeError as e:  # the allocator's OutOfMemoryError, or a library's
            if not (isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)):
                raise
        gc.collect()
        torch.cuda.empty_cache()
        log("data", f"{label}: a step at B={B} does not fit the card "
                    f"({time.perf_counter() - t:.1f} s spent): halving B")
        B //= 2
        if B == 0:
            fail(f"{label}: no step at the loop's defaults fits the card")
    secs = time.perf_counter() - t
    out = buf.getvalue()
    want = (depth * cfg.I * (steps + cfg.val_batches + 1), depth * cfg.I * steps, 0, 0)
    got = train_counts(mixer_cuda, corr_cuda)
    if got != want:
        fail(f"{label}: {TRAIN_KERNELS} launched {got} times, expected {want}")
    losses = [float(v) for v in re.findall(r"loss = ([0-9.eE+-]+)", out)]
    rtime = [float(v) * 1e3 for v in re.findall(r"rtime ([0-9.]+)", out)]
    itime = [float(v) * 1e3 for v in re.findall(r"itime ([0-9.]+)", out)]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses + [*metrics.values()]):
        fail(f"{label}: {len(losses)} step losses, metrics {metrics}")
    saved = saverloader.list_steps(str(Path(cfg.ckpt_dir) / cfg.model_name()))
    if saved != [steps]:
        fail(f"{label}: checkpoints {saved}, expected [{steps}]")
    step_ms = [i - r for i, r in zip(itime[1:], rtime[1:])]  # the first step includes warm-up
    numbers = dict(B=B, loop_s=secs, step_ms=statistics.median(step_ms),
                   loader_wait_ms_median=statistics.median(rtime[1:]),
                   loader_wait_ms_max=max(rtime[1:]),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("data", f"{label}: train.loop.main(B={B}, {cfg.model_name()}) {steps} steps, a validation "
                f"pass of {cfg.val_batches}, media and a checkpoint in {secs:.1f} s; total_loss "
                f"{' '.join(f'{v:.4g}' for v in losses)}; step ms after the first: median "
                f"{numbers['step_ms']:.0f} ({' '.join(f'{v:.0f}' for v in step_ms)}); waited on "
                f"the loader: median {numbers['loader_wait_ms_median']:.0f} ms, max "
                f"{numbers['loader_wait_ms_max']:.0f} ms (first step {rtime[0]:.0f} ms); peak "
                f"memory {numbers['peak_gb']:.2f} GB; launches {got}")
    return dict(launched=got, **numbers)


def phase_data(torch, np, mixer_cuda, corr_cuda, build_dir: Path) -> dict:
    """11: the data path. (a) the host library against its numpy forms;
    (b) a FlyingThings++ tree at 540x960 and ``train.loop.main`` on it at the
    loop's defaults (full-width bf16 Pips, fused channel blocks, augs on; B
    as ``DATA_B``), 12 steps with a validation pass, media and a checkpoint;
    (c) a PointOdyssey tree and ``--model_family pips2 --dataset
    pointodyssey --S 24`` for 6 steps. Prints host ms per sample, step ms and the
    loader waits; returns the launches and the numbers."""
    from pips_tpu_torch.data import FlyingThingsDataset, PointOdysseyDataset

    numbers = {"host_lib_ms": phase_host_lib(np)}
    launched = {"chan_ff_block": 0, "chan_ff_bwd": 0}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=build_dir))
    try:
        t = time.perf_counter()
        make_flyingthings_tree(np, root / "flt")
        make_pointodyssey_tree(np, root / "po")
        log("data", f"trees written in {time.perf_counter() - t:.1f} s: FlyingThings++ "
                    f"{DATA_VIDEOS} videos of {DATA_FRAMES} webp frames at {DATA_HW[0]}x"
                    f"{DATA_HW[1]}, {DATA_TRAJS} points a window; PointOdyssey {DATA_PO_FRAMES} "
                    f"jpg frames, {DATA_PO_POINTS} points")
        with contextlib.redirect_stdout(io.StringIO()):
            ft = FlyingThingsDataset(str(root / "flt"), use_augs=True, N=768, S=8,
                                     crop_size=(384, 512))
            po = PointOdysseyDataset(str(root / "po"), use_augs=True, N=768, S=24,
                                     crop_size=(384, 512))
        for name, ds in (("flyingthings", ft), ("pointodyssey", po)):
            ms = host_ms_per_sample(ds)
            numbers[f"{name} host_ms_per_sample"] = statistics.median(ms)
            log("data", f"{name} host ms per sample on one thread (augs on, N=768): "
                        f"{' '.join(f'{v:.0f}' for v in ms)}, median {statistics.median(ms):.0f}")
        del ft, po
        common = ["--num_workers", "8", "--metrics_every", "1"]
        for name, argv, steps, depth in [
                ("flyingthings", ["--dataset_location", str(root / "flt")], LOOP_DATA_STEPS, DEPTH),
                ("pointodyssey", ["--model_family", "pips2", "--dataset", "pointodyssey",
                                  "--S", "24", "--dataset_location", str(root / "po")],
                 LOOP_PO_STEPS, DEPTH)]:
            cadence = ["--max_iters", str(steps), "--val_freq", str(steps), "--save_freq",
                       str(steps), "--log_freq", str(steps), "--ckpt_dir",
                       str(root / name / "ckpts"), "--log_dir", str(root / name / "logs")]
            got = data_loop(torch, mixer_cuda, corr_cuda, argv + cadence + common, steps,
                            depth, name)
            for k, n in zip(("chan_ff_block", "chan_ff_bwd"), got.pop("launched")):
                launched[k] += n
            numbers.update({f"{name} {k}": v for k, v in got.items()})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launched=launched, **numbers)


def reference_state_dict(sd: dict, depth: int) -> dict:
    """The port's state dict -> the reference model's (``nets/pips.py``)
    names and layouts, with the ``module.`` prefix of a DataParallel model:
    the inverse of ``torchport.convert_pips_state_dict`` composed with the
    port's bridge. Dense kernels (in, out) become Linear weights (out, in),
    the token mixers' Conv1d weights (out, in, 1); norm scales are weights."""
    out = {}
    for key, a in sd.items():
        mods = key.split(".")
        if mods[0] == "fnet":
            m = re.fullmatch(r"layer(\d)_(\d)", mods[1])
            if m:
                mods[1:2] = [f"layer{m[1]}", m[2]]
            if "downsample" in mods:
                mods.insert(mods.index("downsample") + 1, "0")
            out["module." + ".".join(mods)] = a.clone()
            continue
        *path, leaf = mods
        if leaf == "kernel":
            a = a.t()
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        if path[0] == "delta_block":
            name = path[2]
            m = re.fullmatch(r"block(\d+)_(token|chan)(_norm)?", name)
            if m:
                d, sub = int(m[1]) + 1, "0" if m[2] == "token" else "1"
                if m[3]:
                    name = f"{d}.{sub}.norm"
                else:
                    fc = {"fc1": 0, "fc2": 3}[path[3]]
                    name = f"{d}.{sub}.fn.{fc}"
                    if m[2] == "token" and leaf == "weight":
                        a = a[:, :, None]
            else:
                name = str({"embed": 0, "final_norm": depth + 1, "head": depth + 3}[name])
            name = f"delta_block.to_delta.{name}"
        else:
            name = {"ffeat_norm": "norm", "ffeat_updater": "ffeat_updater.0",
                    "vis_predictor": "vis_predictor.0"}[path[0]]
        out[f"module.{name}.{leaf}"] = a.contiguous().clone()
    return out


def make_crohd_tree(np, root: Path) -> None:
    """CroHD (HT21 train) at ``EVAL_CROHD_HW``: HT21-01 holds
    ``EVAL_CROHD_WINDOWS`` 24-frame windows of jpg frames and the heads'
    MOT rows; HT21-02..04 one label row each (no whole window)."""
    H, W = EVAL_CROHD_HW
    rng = np.random.RandomState(21)
    T = 24 * EVAL_CROHD_WINDOWS
    starts = rng.rand(EVAL_CROHD_HEADS, 2) * [W - 300, H - 200] + 100
    vel = rng.choice([-1.0, 1.0], (EVAL_CROHD_HEADS, 2)) * [4.0, 2.0]
    frames = []
    for i, sub in enumerate(("HT21-01", "HT21-02", "HT21-03", "HT21-04")):
        img, gt = root / "HT21/train" / sub / "img1", root / "HT21Labels/train" / sub / "gt"
        img.mkdir(parents=True)
        gt.mkdir(parents=True)
        rows = []
        for fr in range(T if i == 0 else 1):
            if i == 0:
                frames.append((img / f"{fr + 1:06d}.jpg", data_frame(np, rng, H, W)))
            for h in range(EVAL_CROHD_HEADS):
                x, y = starts[h] + vel[h] * (fr % 24)  # each window from its start
                vis = int(not (h < EVAL_CROHD_OCCLUDED and 12 <= fr % 24 < 15))
                rows.append(f"{fr + 1},{h + 1},{x - 20:.1f},{y - 20:.1f},40,40,1,1,{vis}")
        (gt / "gt.txt").write_text("\n".join(rows))
    save_frames(frames)


def make_badja_tree(np, root: Path) -> None:
    """BADJA: one ``EVAL_BADJA_T``-frame DAVIS video at ``EVAL_BADJA_HW``
    (jpg frames, png segmentations) with its joint annotations, as
    tests/tests_treeutil.py lays out its small tree."""
    from PIL import Image

    H, W = EVAL_BADJA_HW
    rng = np.random.RandomState(22)
    (root / "joint_annotations").mkdir(parents=True)
    img_dir = root / "DAVIS/JPEGImages/Full-Resolution/bear"
    seg_dir = root / "DAVIS/Annotations/Full-Resolution/bear"
    img_dir.mkdir(parents=True)
    seg_dir.mkdir(parents=True)
    ann, frames = [], []
    for fr in range(EVAL_BADJA_T):
        frames.append((img_dir / f"{fr:05d}.jpg", data_frame(np, rng, H, W)))
        seg = np.zeros((H, W), np.uint8)
        seg[H // 5 + 3 * fr:H * 3 // 4 + 3 * fr, W // 4:W * 3 // 4] = 255
        Image.fromarray(seg).save(seg_dir / f"{fr:05d}.png")
        ann.append({"image_path": f"DAVIS/JPEGImages/Full-Resolution/bear/{fr:05d}.jpg",
                    "segmentation_path": f"DAVIS/Annotations/Full-Resolution/bear/{fr:05d}.png",
                    "joints": (rng.rand(37, 2) * [H * 0.5, W * 0.5] + [H * 0.25, W * 0.25]
                               + 2.0 * fr).tolist(),  # (y, x)
                    "visibility": (rng.rand(37) < 0.9).astype(int).tolist()})
    (root / "joint_annotations" / "bear.json").write_text(json.dumps(ann))
    save_frames(frames)


def make_davis_tree(np, root: Path, videos: int = EVAL_DAVIS_VIDEOS) -> None:
    """DAVIS: ``videos`` videos of 8 jpg frames at ``EVAL_DAVIS_HW``."""
    H, W = EVAL_DAVIS_HW
    rng = np.random.RandomState(23)
    frames = []
    for v in range(videos):
        vd = root / "JPEGImages/Full-Resolution" / f"video{v}"
        vd.mkdir(parents=True)
        frames += [(vd / f"{fr:05d}.jpg", data_frame(np, rng, H, W)) for fr in range(8)]
    save_frames(frames)


@contextlib.contextmanager
def timed_windows(torch, window_tracker):
    """Time every ``WindowTracker`` call (``__call__``, and ``track``, which
    ``ChainTracker`` calls) on the host clock, ending in a device sync.
    Yields the list the seconds go to."""
    secs = []
    call, track = window_tracker.__call__, window_tracker.track

    def timed(fn):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return out
        return run

    window_tracker.__call__, window_tracker.track = timed(call), timed(track)
    try:
        yield secs
    finally:
        window_tracker.__call__, window_tracker.track = call, track


def media_files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.suffix in (".png", ".gif"))


def phase_evals(torch, np, mixer_cuda, mixer_module, root: Path) -> dict:
    """12: the eval runners (``pips_tpu_torch.evals.run_{flt,crohd,badja,
    davis}.main``, as the CLI calls them) at the sets' frame sizes on the
    flagship's width: seeded weights written as a reference-format ``.pth``
    that ``load_params`` must give back bit for bit; each runner in bf16 with
    finite metrics, its media written and 12 * 6 ``chan_ff_block`` launches a
    window; ``run_flt`` also in f32 (the default: no kernel). The bf16
    trajectories against the plain channel block within ``SIX_ITERS``:
    DAVIS's dense ``trajs``, and ``build_pips_tracker`` on the first
    FlyingThings++ and CroHD samples. The trees stay under ``root`` for phase
    13. Returns the launches and the numbers."""
    from pips_tpu_torch.data import CrohdDataset, FlyingThingsDataset
    from pips_tpu_torch.data.crohd import prep_sample
    from pips_tpu_torch.evals import common, run_badja, run_crohd, run_davis, run_flt
    from pips_tpu_torch.inference.window import WindowTracker

    launched, numbers = {"chan_ff_block": 0}, {}
    t = time.perf_counter()
    make_flyingthings_tree(np, root / "flt", {"TEST": DATA_VIDEOS["TEST"]})
    make_crohd_tree(np, root / "crohd")
    make_badja_tree(np, root / "badja")
    make_davis_tree(np, root / "davis")
    # seeded weights, written in the reference's layout
    want_sd = seeded_weights(torch)
    pth = root / "ckpt" / "model-000200000.pth"
    pth.parent.mkdir()
    torch.save({"model_state_dict": reference_state_dict(want_sd, DEPTH),
                "optimizer_state_dict": {}}, pth)
    with contextlib.redirect_stdout(io.StringIO()):
        got_sd = common.load_params(common.make_pips(dtype="bfloat16"), str(pth)).state_dict()
    bad = [k for k in want_sd if not torch.equal(got_sd[k].cpu(), want_sd[k])]
    if sorted(got_sd) != sorted(want_sd) or bad:
        fail(f"evals: load_params of the reference-format .pth differs at {bad[:5]}")
    log("evals", f"trees and a reference-format .pth ({len(want_sd)} entries, module. "
                 f"prefix) in {time.perf_counter() - t:.1f} s; load_params gives the state "
                 f"dict back bit for bit")

    runs = [
        ("flt bf16", run_flt.main, dict(dataset_location=str(root / "flt"),
                                        max_iters=EVAL_FLT_WINDOWS, log_freq=2,
                                        log_dir=str(root / "out/flt_bf16"),
                                        dtype="bfloat16"), root / "out/flt_bf16"),
        ("flt f32", run_flt.main, dict(dataset_location=str(root / "flt"),
                                       max_iters=EVAL_FLT_WINDOWS, log_freq=2,
                                       log_dir=str(root / "out/flt_f32")),
         root / "out/flt_f32"),
        # media of the first window only: where imageio is absent, PIL
        # writes the GIFs and takes ~15 s to quantize 8 frames at 1080x1920
        ("crohd bf16", run_crohd.main, dict(dataset_root=str(root / "crohd"),
                                            log_freq=EVAL_CROHD_WINDOWS,
                                            log_dir=str(root / "out/crohd"),
                                            dtype="bfloat16"), root / "out/crohd"),
        ("badja bf16", run_badja.main, dict(data_dir=str(root / "badja"),
                                            out_dir=str(root / "out/badja"),
                                            dtype="bfloat16"), root / "out/badja")]
    runs += [(f"davis bf16 chunk {c}", run_davis.main,
              dict(davis_dir=str(root / "davis"), chunk=c, dtype="bfloat16",
                   out_dir=str(root / f"out/davis_{c}")), root / f"out/davis_{c}")
             for c in EVAL_DAVIS_CHUNKS]
    outs = {}
    for name, main_fn, kw, out_dir in runs:
        torch.cuda.synchronize()
        mixer_cuda.launches = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with timed_windows(torch, WindowTracker) as secs, contextlib.redirect_stdout(buf):
            out = main_fn(init_dir=str(pth), **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        n_ff, bf16 = mixer_cuda.launches, "bf16" in name
        want_ff = DEPTH * ITERS * len(secs) if bf16 else 0
        if len(secs) < 2 or n_ff != want_ff:
            fail(f"evals {name}: {len(secs)} windows, chan_ff_block launched {n_ff} times, "
                 f"expected {want_ff}")
        launched["chan_ff_block"] += n_ff
        files = media_files(out_dir)
        if not files:
            fail(f"evals {name}: no media under {out_dir}")
        if name.startswith("davis"):
            per_video = len(secs) // EVAL_DAVIS_VIDEOS
            steady_tps = EVAL_DAVIS_POINTS / sum(secs[-per_video:])
            finite = (np.isfinite(out["trajs"]).all() and out["mean_tps"] > 0
                      and out["trajs"].shape == (8, EVAL_DAVIS_POINTS, 2))
            shown = (f"TPS {steady_tps:.0f} on the last video, the runner's mean "
                     f"{out['mean_tps']:.0f} (first video cold)")
            numbers[f"{name} tps"], numbers[f"{name} steady_tps"] = (out["mean_tps"],
                                                                      steady_tps)
        elif name.startswith("badja"):
            finite = math.isfinite(out["avg"])
            shown = f"PCK {out['avg']:.2f}"
        else:
            finite = all(math.isfinite(out[k]) for k in ("ate_all", "ate_vis"))
            shown = ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        if not finite:
            fail(f"evals {name}: non-finite result {out}")
        outs[name] = out
        first_ms, med_ms = secs[0] * 1e3, statistics.median(secs[1:]) * 1e3
        numbers[f"{name} s"], numbers[f"{name} window_ms_median"] = run_s, med_ms
        numbers[f"{name} first_window_ms"] = first_ms
        numbers[f"{name} windows"], numbers[f"{name} chan_ff_block"] = len(secs), n_ff
        log("evals", f"{name}: {shown}; {run_s:.2f} s, {len(secs)} windows (host clock): "
                     f"the first {first_ms:.1f} ms, then median {med_ms:.1f} ms of "
                     f"{len(secs) - 1}; {n_ff} chan_ff_block launches; media "
                     f"{', '.join(files[:3])}{' ...' if len(files) > 3 else ''}")
        gc.collect()
        torch.cuda.empty_cache()

    # the bf16 trajectories against the plain channel block
    with contextlib.redirect_stdout(io.StringIO()):
        with plain_channel_blocks(mixer_module, mixer_cuda.chan_ff_reference):
            plain = run_davis.main(init_dir=str(pth), davis_dir=str(root / "davis"), chunk=0,
                                   dtype="bfloat16")["trajs"]
        ft = FlyingThingsDataset(str(root / "flt"), dset="TEST", N=16, S=8,
                                 crop_size=(384, 512))
        first = ft[int(np.random.RandomState(125).permutation(len(ft))[0])][0]
        ch = prep_sample(CrohdDataset(seqlen=24, dataset_root=str(root / "crohd"))[0],
                         N_max=16, S_stride=3, req_occlusion=True)[0]
        samples = [("flt", 8, first["trajs"][None, 0], first["rgbs"][None]),
                   ("crohd", 4, ch["trajs_g"][:, 0], ch["rgbs"])]
        pairs = [("davis chunk 0", outs["davis bf16 chunk 0"]["trajs"], plain)]
        for label, stride, xys, rgbs in samples:
            track = common.build_pips_tracker(str(pth), S=8, stride=stride, iters=ITERS,
                                              dtype="bfloat16")
            kernel = track(xys, rgbs)
            with plain_channel_blocks(mixer_module, mixer_cuda.chan_ff_reference):
                pairs.append((f"{label} first sample", kernel, track(xys, rgbs)))
    for label, a, b in pairs:
        d = np.abs(a - b)
        six = dict(median=float(np.median(d)), p90=float(np.percentile(d, 90)),
                   max=float(d.max()))
        log("evals", f"{label}, bf16 kernel vs plain channel block, 6 iters: traj median "
                     f"{six['median']:.3g} px, p90 {six['p90']:.3g}, max {six['max']:.3g}")
        if not (np.isfinite(a).all() and six["median"] < SIX_ITERS["median"]
                and six["p90"] < SIX_ITERS["p90"]):
            fail(f"evals {label}: drift beyond {SIX_ITERS}: {six}")
        numbers[f"{label} drift"] = six
    return dict(launched=launched, **numbers)


def raft_things_state_dict(torch, seed: int) -> dict:
    """Seeded RAFT weights in the layout of the published ``raft-things.pth``
    (fnet 256, cnet 128+128 with batch norms, 4 levels of radius 4, the
    ``module.`` prefix of a DataParallel model, ``num_batches_tracked`` and
    the ``downsample.1`` aliases of ``norm3``): convs He-normal over their
    fan-in (the flow head's last at a tenth of it: He-scaled updates move
    points ~25 px an iteration, off the frame within a few), biases and norm
    parameters and statistics moved off 0 and 1."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    def conv(name, o, i, kh, kw):
        sd[f"{name}.weight"] = randn(o, i, kh, kw) * math.sqrt(2.0 / (i * kh * kw))
        sd[f"{name}.bias"] = 0.05 * randn(o)

    def bn(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + 0.1 * randn(c), 0.05 * randn(c)
        sd[f"{name}.running_mean"] = 0.1 * randn(c)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(100000)

    for enc, batch in (("fnet", False), ("cnet", True)):
        conv(f"{enc}.conv1", 64, 3, 7, 7)
        if batch:
            bn(f"{enc}.norm1", 64)
        c_in = 64
        for stage, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)], 1):
            for blk in (0, 1):
                s, ci = (stride, c_in) if blk == 0 else (1, dim)
                p = f"{enc}.layer{stage}.{blk}"
                conv(f"{p}.conv1", dim, ci, 3, 3)
                conv(f"{p}.conv2", dim, dim, 3, 3)
                if batch:
                    bn(f"{p}.norm1", dim)
                    bn(f"{p}.norm2", dim)
                if s != 1:
                    conv(f"{p}.downsample.0", dim, ci, 1, 1)
                    if batch:
                        bn(f"{p}.norm3", dim)
                        for k in [k for k in sd if k.startswith(f"{p}.norm3.")]:
                            sd[k.replace(".norm3.", ".downsample.1.")] = sd[k]
            c_in = dim
        conv(f"{enc}.conv2", 256, 128, 1, 1)
    u = "update_block"
    conv(f"{u}.encoder.convc1", 256, 4 * 81, 1, 1)
    conv(f"{u}.encoder.convc2", 192, 256, 3, 3)
    conv(f"{u}.encoder.convf1", 128, 2, 7, 7)
    conv(f"{u}.encoder.convf2", 64, 128, 3, 3)
    conv(f"{u}.encoder.conv", 126, 256, 3, 3)
    for gate in "zrq":
        conv(f"{u}.gru.conv{gate}1", 128, 384, 1, 5)
        conv(f"{u}.gru.conv{gate}2", 128, 384, 5, 1)
    conv(f"{u}.flow_head.conv1", 256, 128, 3, 3)
    conv(f"{u}.flow_head.conv2", 2, 256, 3, 3)
    sd[f"{u}.flow_head.conv2.weight"] *= 0.1  # updates of a few px, as trained weights make
    conv(f"{u}.mask.0", 256, 128, 3, 3)
    conv(f"{u}.mask.2", 64 * 9, 256, 1, 1)
    return {f"module.{k}": v for k, v in sd.items()}


def raft_port_state(sd: dict) -> dict:
    """What the port's ``RAFT`` must hold after loading ``sd`` (a
    ``raft_things_state_dict``), by the reference's names: the module tree's
    renames, norm weights as scales, running statistics as the ``mean`` and
    ``var`` buffers, the GRU's bare convs in flax's (kh, kw, I, O) layout;
    ``num_batches_tracked`` and the ``downsample.1`` aliases dropped."""
    out = {}
    for key, a in sd.items():
        k = key.removeprefix("module.")
        if k.endswith("num_batches_tracked") or ".downsample.1." in k:
            continue
        k = re.sub(r"layer(\d)\.(\d)\.", r"layer\1_\2.", k)
        for old, new in (("downsample.0.", "downsample."), ("mask.0.", "mask1."),
                         ("mask.2.", "mask2."), (".running_mean", ".mean"),
                         (".running_var", ".var")):
            k = k.replace(old, new)
        k = re.sub(r"(norm\d)\.weight$", r"\1.scale", k)
        if ".gru." in k and k.endswith(".weight"):
            k, a = k.removesuffix("weight") + "kernel", a.permute(2, 3, 1, 0)
        out[k] = a.contiguous()
    return out


def dino_release_state_dict(torch, seed: int, dim: int = 384, depth: int = 12,
                            grid: int = 28) -> dict:
    """Seeded ViT-S/8 weights in the layout of DINO's released
    ``dino_deitsmall8_pretrain.pth`` (``pos_embed`` on its 28x28 training
    grid): linear layers and embeddings normal(0.02), norm scales 1 +
    normal(0.1), biases normal(0.02)."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, std=0.02, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen)

    sd = {"patch_embed.proj.weight": randn(dim, 3, 8, 8), "patch_embed.proj.bias": randn(dim),
          "cls_token": randn(1, 1, dim), "pos_embed": randn(1, 1 + grid * grid, dim),
          "norm.weight": randn(dim, std=0.1, mean=1.0), "norm.bias": randn(dim)}
    for d in range(depth):
        p = f"blocks.{d}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = randn(dim, std=0.1, mean=1.0), randn(dim)
        for name, o, i in (("attn.qkv", 3 * dim, dim), ("attn.proj", dim, dim),
                           ("mlp.fc1", 4 * dim, dim), ("mlp.fc2", dim, 4 * dim)):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = randn(o, i), randn(o)
    return sd


def dino_port_state(sd: dict, heads: int = 6) -> dict:
    """What the port's ``ViT`` must hold after loading ``sd`` at its own
    grid: flax's layouts (the patch kernel (8, 8, 3, dim), q/k/v (dim,
    heads, head_dim), the out projection (heads, head_dim, dim), dense
    kernels (in, out)), norm weights as scales."""
    dim = sd["cls_token"].shape[-1]
    hd = dim // heads
    out = {"patch_embed.kernel": sd["patch_embed.proj.weight"].permute(2, 3, 1, 0),
           "patch_embed.bias": sd["patch_embed.proj.bias"], "cls_token": sd["cls_token"],
           "pos_embed": sd["pos_embed"], "norm.scale": sd["norm.weight"],
           "norm.bias": sd["norm.bias"]}
    for key in sd:
        m = re.fullmatch(r"blocks\.(\d+)\.(norm1|norm2)\.weight", key)
        if not m:
            continue
        d, p = m[1], f"blocks.{m[1]}"
        out[f"block{d}.{m[2]}.scale"] = sd[key]
        out[f"block{d}.{m[2]}.bias"] = sd[f"{p}.{m[2]}.bias"]
        if m[2] == "norm2":
            continue
        for name, w, b in zip(("query", "key", "value"), sd[f"{p}.attn.qkv.weight"].chunk(3),
                              sd[f"{p}.attn.qkv.bias"].chunk(3)):
            out[f"block{d}.attn.{name}.kernel"] = w.t().reshape(dim, heads, hd)
            out[f"block{d}.attn.{name}.bias"] = b.reshape(heads, hd)
        out[f"block{d}.attn.out.kernel"] = sd[f"{p}.attn.proj.weight"].t().reshape(heads, hd, dim)
        out[f"block{d}.attn.out.bias"] = sd[f"{p}.attn.proj.bias"]
        for fc in ("fc1", "fc2"):
            out[f"block{d}.{fc}.kernel"] = sd[f"{p}.mlp.{fc}.weight"].t()
            out[f"block{d}.{fc}.bias"] = sd[f"{p}.mlp.{fc}.bias"]
    return {k: v.contiguous() for k, v in out.items()}


@contextlib.contextmanager
def timed_baseline_windows(torch, common):
    """Time every call of the trackers ``common.build_baseline_tracker``
    builds (the runners look the builder up at call time) on the host clock,
    ending in a device sync. Yields the list the seconds go to."""
    secs, build = [], common.build_baseline_tracker

    def timed_build(*args, **kw):
        track = build(*args, **kw)

        def run(*targs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = track(*targs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return out
        return run

    common.build_baseline_tracker = timed_build
    try:
        yield secs
    finally:
        common.build_baseline_tracker = build


@contextlib.contextmanager
def torch_tf32_defaults(torch):
    """PyTorch's defaults inside (cuDNN convs may use TF32, matmuls may
    not); the smoke's settings (TF32 off) are restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def phase_baselines(torch, np, root: Path, zero_counts, kernel_counts) -> dict:
    """13: the RAFT and DINO baselines, f32, on the card: (a) seeded weights
    in the release files' layouts, which the port's loaders put into its
    modules bit for bit; (b) one window through ``build_baseline_tracker`` on
    the card and on the CPU with TF32 off (RAFT at ``BASE_RAFT_ITERS``,
    DINO); (c) ``run_flt``, ``run_badja`` and ``run_crohd`` with each
    baseline on phase 12's trees under ``root``, at PyTorch's TF32
    defaults: finite metrics, media; (d)
    no kernel of the port launched in any of these runs. Returns the
    numbers."""
    from pips_tpu_torch.convert import load_flax_params
    from pips_tpu_torch.evals import common, run_badja, run_crohd, run_flt
    from pips_tpu_torch.models.dino import ViT
    from pips_tpu_torch.models.raft import RAFT
    from pips_tpu_torch.torchport import convert_dino_vit_state_dict, convert_raft_state_dict

    require_full_f32(torch)
    numbers = {}
    t = time.perf_counter()
    ckpt = root / "baselines"
    ckpt.mkdir()
    pths = {"raft": ckpt / "raft-things.pth", "dino": ckpt / "dino_deitsmall8_pretrain.pth"}
    raft_sd, dino_sd = raft_things_state_dict(torch, 13), dino_release_state_dict(torch, 14)
    torch.save(raft_sd, pths["raft"])
    torch.save(dino_sd, pths["dino"])
    # (a) the loaders' path: the file, the converter, the bridge into the module
    raw = common.load_raft_state_dict(str(pths["raft"]))
    loaded = {"raft": load_flax_params(RAFT(), convert_raft_state_dict(raw)).state_dict()}
    sd = common.load_dino_state_dict(str(pths["dino"]))
    dim, depth, heads, patch = common.infer_dino_arch(sd)
    if (dim, depth, heads, patch) != (384, 12, 6, 8):
        fail(f"baselines: infer_dino_arch gives {(dim, depth, heads, patch)} for ViT-S/8")
    loaded["dino"] = load_flax_params(
        ViT(patch, dim, depth, heads, grid_hw=(28, 28)),
        convert_dino_vit_state_dict(sd, grid_hw=(28, 28), dim=dim, heads=heads,
                                    depth=depth)).state_dict()
    for name, want in (("raft", raft_port_state(raft_sd)), ("dino", dino_port_state(dino_sd))):
        got = loaded[name]
        bad = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        if sorted(got) != sorted(want) or bad:
            fail(f"baselines: the {name} loader does not give the file back bit for bit: "
                 f"{bad[:5]}, {sorted(set(got) ^ set(want))[:5]}")
    log("baselines", f"raft-things layout ({len(raft_sd)} entries) and ViT-S/8 ({len(dino_sd)} "
                     f"entries, pos_embed 1+28*28) written in {time.perf_counter() - t:.1f} s; "
                     f"the port's modules hold them bit for bit ({len(loaded['raft'])} and "
                     f"{len(loaded['dino'])} tensors)")
    del loaded, raw, sd

    # (b) one window on the card and on the CPU, the same port code
    H, W = BASE_HW
    rng = np.random.RandomState(15)
    base = data_frame(np, rng, H, W)
    rgbs = np.stack([np.roll(base, (s, 2 * s), axis=(0, 1)) for s in range(8)])[None]
    rgbs = rgbs.astype(np.float32)
    xys = (rng.rand(1, BASE_N, 2) * [W - 1, H - 1]).astype(np.float32)
    cases = [(f"raft {it} iters", "raft", it) for it in BASE_RAFT_ITERS] + [("dino", "dino", 0)]
    for label, model, iters in cases:
        trajs, secs = {}, {}
        for where, device in (("card", "cuda"), ("cpu", "cpu")):
            track = common.build_baseline_tracker(model, str(pths[model]), raft_iters=iters,
                                                  device=device)
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            trajs[where] = track(xys, rgbs)
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t
            if sum(kernel_counts().values()):
                fail(f"baselines {label} on {where}: port kernels launched {kernel_counts()}")
        a, b = trajs["card"], trajs["cpu"]
        if not (a.shape == b.shape == (1, 8, BASE_N, 2) and np.isfinite(a).all()
                and np.array_equal(a[:, 0], xys)):
            fail(f"baselines {label}: trajectories {a.shape}, finite {np.isfinite(a).all()}")
        d = np.abs(a - b)
        six = dict(median=float(np.median(d)), p90=float(np.percentile(d, 90)), max=float(d.max()))
        moved = float(np.abs(a - a[:, :1]).max())
        ok = (six["median"] < SIX_ITERS["median"] and six["p90"] < SIX_ITERS["p90"]
              if iters == BASE_RAFT_ITERS[-1] else six["max"] <= BASE_PX)
        log("baselines", f"{label}, {H}x{W} N={BASE_N}, card vs CPU (TF32 off): median "
                         f"{six['median']:.3g} px, p90 {six['p90']:.3g}, max {six['max']:.3g} "
                         f"(points moved up to {moved:.1f} px); card {secs['card']:.2f} s, CPU "
                         f"{secs['cpu']:.2f} s")
        if not ok:
            bound = SIX_ITERS if iters == BASE_RAFT_ITERS[-1] else f"max {BASE_PX}"
            fail(f"baselines {label}: the card and the CPU differ beyond {bound}: {six}")
        numbers[f"{label} card vs cpu"] = six
        numbers[f"{label} card_s"], numbers[f"{label} cpu_s"] = secs["card"], secs["cpu"]

    # (c) the runners on phase 12's trees at PyTorch's defaults, as a user runs
    # them (cuDNN convs in TF32, matmuls in full f32), (d) with no port kernel
    # launched
    out = root / "out_baselines"
    runs = []
    for m in ("raft", "dino"):
        runs += [(f"flt {m}", run_flt.main, dict(dataset_location=str(root / "flt"),
                                                 max_iters=EVAL_FLT_WINDOWS, log_freq=2,
                                                 log_dir=str(out / f"flt_{m}")), out / f"flt_{m}"),
                 (f"badja {m}", run_badja.main, dict(data_dir=str(root / "badja"),
                                                     out_dir=str(out / f"badja_{m}")),
                  out / f"badja_{m}"),
                 (f"crohd {m}", run_crohd.main, dict(dataset_root=str(root / "crohd"),
                                                     max_iters=BASE_CROHD_WINDOWS,
                                                     log_freq=BASE_CROHD_WINDOWS,
                                                     log_dir=str(out / f"crohd_{m}")),
                  out / f"crohd_{m}")]
    for name, main_fn, kw, out_dir in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with (timed_baseline_windows(torch, common) as secs, contextlib.redirect_stdout(buf),
              torch_tf32_defaults(torch)):
            res = main_fn(init_dir=str(pths[name.split()[1]]), modeltype=name.split()[1], **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = {k: n for k, n in kernel_counts().items() if n}
        if launched:
            fail(f"baselines {name}: the port's kernels launched {launched}")
        files = media_files(out_dir)
        if not secs or not files:
            fail(f"baselines {name}: {len(secs)} windows, media {files}")
        if name.startswith("badja"):
            finite, shown = math.isfinite(res["avg"]), f"PCK {res['avg']:.2f}"
        else:
            finite = all(math.isfinite(res[k]) for k in ("ate_all", "ate_vis"))
            shown = ", ".join(f"{k} {v:.3f}" for k, v in res.items())
        if not finite:
            fail(f"baselines {name}: non-finite result {res}")
        rest = statistics.median(secs[1:]) * 1e3 if len(secs) > 1 else float("nan")
        numbers[f"{name} s"], numbers[f"{name} windows"] = run_s, len(secs)
        numbers[f"{name} first_window_ms"], numbers[f"{name} window_ms_median"] = (
            secs[0] * 1e3, rest)
        numbers[f"{name} peak_gb"] = peak_gb
        log("baselines", f"{name}: {shown}; {run_s:.2f} s, {len(secs)} windows (host clock): "
                         f"the first {secs[0] * 1e3:.1f} ms, then median {rest:.1f} ms of "
                         f"{len(secs) - 1}; peak {peak_gb:.2f} GB; no port kernel launched; "
                         f"media {', '.join(files[:2])}{' ...' if len(files) > 2 else ''}")
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def seeded_weights(torch) -> dict:
    """The flagship's seeded full-width weights of phases 12 and 14:
    ``init_params(Pips(), 0)`` with every bias and norm scale moved off 0 and
    1, so that a misplaced leaf shows."""
    from pips_tpu_torch import init_params
    from pips_tpu_torch.models.pips import Pips

    src = init_params(Pips(), 0)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if name.endswith((".bias", ".scale")):
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return src.state_dict()


def msgpack_bytes(np, obj) -> bytes:
    """``obj`` (maps, lists, str, small ints, ndarrays) in the msgpack that
    ``flax.serialization.to_bytes`` writes: an ndarray as extension type 1,
    a packed (shape, dtype name, C-order bytes)."""
    import struct

    if isinstance(obj, dict):
        head = bytes([0x80 | len(obj)]) if len(obj) < 16 else b"\xde" + struct.pack(">H", len(obj))
        return head + b"".join(msgpack_bytes(np, str(k)) + msgpack_bytes(np, v)
                               for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        head = bytes([0x90 | len(obj)]) if len(obj) < 16 else b"\xdc" + struct.pack(">H", len(obj))
        return head + b"".join(msgpack_bytes(np, v) for v in obj)
    if isinstance(obj, str):
        b = obj.encode()
        return (bytes([0xA0 | len(b)]) if len(b) < 32 else b"\xd9" + bytes([len(b)])) + b
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, int):
        return bytes([obj]) if 0 <= obj < 128 else b"\xce" + struct.pack(">I", obj)
    a = np.ascontiguousarray(obj)
    payload = msgpack_bytes(np, [[int(d) for d in a.shape], a.dtype.name, a.tobytes()])
    return b"\xc9" + struct.pack(">I", len(payload)) + b"\x01" + payload


def write_jax_checkpoint(torch, np, sd: dict, ckpt_dir: Path, step: int) -> Path:
    """``sd`` as the JAX package's bare variables checkpoint
    (``model-%09d.msgpack`` of ``{"params": ...}``), through the bridge."""
    from pips_tpu_torch.convert import flax_from_state_dict

    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"model-{step:09d}.msgpack"
    path.write_bytes(msgpack_bytes(np, flax_from_state_dict(sd)))
    return path


MESH_CHILD = r'''
import json, runpy, sys, time
T0 = time.perf_counter()
import numpy as np
import torch
pid, port, smoke = int(sys.argv[1]), sys.argv[2], sys.argv[3]
g = runpy.run_path(smoke, run_name="mesh_child")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from pips_tpu_torch import WindowTracker, grid_queries, make_pips
from pips_tpu_torch.parallel import (distributed_init, make_mesh, make_sharded_train_step,
                                     replicate, shard_batch)
from pips_tpu_torch.train import make_optimizer, make_train_step

distributed_init(f"localhost:{port}", 2, pid, backend="gloo", device="cuda")
cfg = g["MESH_TRAIN"]
batch = g["train_batch"](torch, np, cfg, seed=3)
out = {"steps": [], "windows": []}
meshes = {shape: make_mesh(shape, device="cuda") for shape in g["MESH_SHAPES"]}
out["ready_s"] = time.perf_counter() - T0


def grads(m):
    return {n: p.grad.detach().float().clone() for n, p in m.named_parameters()}


f32_ref = None
for dtype, iters in g["MESH_STEPS"]:
    dt = getattr(torch, dtype)
    m = make_pips(device="cuda", seed=0, dtype=None if dt == torch.float32 else dt,
                  fuse_chanff=dt != torch.float32).train()
    init = {k: v.detach().clone() for k, v in m.state_dict().items()}
    out.setdefault("built_s", []).append(time.perf_counter() - T0)
    # the one-process step on the same global batch, on every rank, so that
    # the ranks' first steps (which load the libraries) overlap
    opt = make_optimizer(m.parameters(), lr=5e-4, num_steps=10)
    met = make_train_step(m, opt, iters=iters, horz_flip=False, vert_flip=False)(batch)
    ref = (met, grads(m))
    m.load_state_dict(init)
    # the (2, 1) mesh's two B=1 halves in this process, with no collective
    split = g["split_step"](torch, m, batch, iters)
    out.setdefault("split_vs_one", {})[dtype] = dict(
        g["grad_parity"](torch, split, ref),
        encode_rel=g["encode_split_diff"](torch, m, batch["rgbs"]))
    if dt == torch.float32:
        f32_ref = ref
    else:  # how far bf16 alone moves the one-process step from the f32 one
        out.setdefault("single_vs_f32", {})[str(iters)] = g["grad_parity"](torch, ref, f32_ref)
    out.setdefault("ref_s", []).append(time.perf_counter() - T0)
    for shape, mesh in meshes.items():
        m.load_state_dict(init)
        replicate(m)
        opt = make_optimizer(m.parameters(), lr=5e-4, num_steps=10)
        step = make_sharded_train_step(m, opt, mesh, iters=iters, horz_flip=False,
                                       vert_flip=False)
        shard = shard_batch(mesh, batch)
        met = step(shard)
        got = (met, grads(m))
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(shard)
        torch.cuda.synchronize()
        entry = dict(dtype=dtype, shape=list(shape), iters=iters, at_s=time.perf_counter() - T0,
                     ms=(time.perf_counter() - t) * 1e3, loss=met["total_loss"],
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        entry.update(g["grad_parity"](torch, got, ref))
        if shape == (2, 1):
            entry["vs_split"] = g["grad_parity"](torch, got, split)
        out["steps"].append(entry)
        del opt, step, got
    del m, init, ref, split
    torch.cuda.empty_cache()

m = make_pips(device="cuda", seed=0).eval()
rng = np.random.RandomState(4)
H, W = g["MESH_WINDOW_HW"]
rgbs = (rng.rand(1, 8, H, W, 3) * 255).astype(np.float32)
xys = grid_queries(H, W)
for iters in (1, 6):
    torch.cuda.synchronize()
    t = time.perf_counter()
    split = WindowTracker(m, iters=iters, device="cuda", mesh=meshes[(1, 2)])(xys, rgbs)
    torch.cuda.synchronize()
    w = dict(iters=iters, ms=(time.perf_counter() - t) * 1e3,
             finite=bool(all(np.isfinite(a).all() for a in split)))
    if pid == 0:
        whole = WindowTracker(m, iters=iters, device="cuda")(xys, rgbs)
        d = np.abs(split[0] - whole[0])
        w.update(max=float(d.max()), median=float(np.median(d)),
                 p90=float(np.percentile(d, 90)), vis_max=float(np.abs(split[1] - whole[1]).max()),
                 moved=float(np.abs(whole[0] - whole[0][:, :1]).max()))
    out["windows"].append(w)
out["end_s"] = time.perf_counter() - T0
print("RESULT " + json.dumps(out), flush=True)
'''


def run_two_ranks(np) -> list:
    """MESH_CHILD in two processes on the one card, joined over gloo; their
    RESULT dicts by rank. Kills both on a timeout or a failure."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = Path(__file__).resolve()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(here.parent), env.get("PYTHONPATH")]))
    procs = [subprocess.Popen([sys.executable, "-c", MESH_CHILD, str(i), str(port), str(here)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=here.parent, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_CHILD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"mesh: the two ranks did not finish in {MESH_CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            fail(f"mesh: rank {i} exited {p.returncode}:\n{out[-4000:]}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


def phase_modules(torch, np, mixer_cuda, corr_cuda, root: Path) -> dict:
    """14: the port's last modules. (a) phase 12's seeded weights written as a
    JAX msgpack checkpoint, which ``load_params`` must give back bit for bit;
    (b) ``demo.main`` and ``chain_demo.main`` (default, ``on_device`` and
    ``stream``) at ``--bf16 true`` on DEMO_FRAMES seeded noise jpgs at
    DEMO_HW, from that checkpoint: their GIFs written, every trajectory
    finite and at its query on frame 0, 12 * 6 ``chan_ff_block`` launches a
    window, ``stream`` within EXACT_PX of the default and ``on_device``
    within phase 6's bounds; (c) ``parallel`` at world size 1 over NCCL: a
    sharded bf16 step at the bench train shape against the one-process step
    within PARITY, and ``run_davis --mesh auto`` on one video equal to
    ``--mesh ''``; (d) two ranks on the card over gloo (``run_two_ranks``):
    at meshes (2, 1) and (1, 2) the MESH_STEPS against the one-process step
    on the same global batch: f32 (TF32 off) within MESH_F32, bf16 within
    PARITY, at (2, 1) of ``split_step`` (held to the one-process step within
    MESH_F32 in f32, and read beside it in bf16: what the split alone does);
    a point-split f32 window within EXACT_PX of the unsplit one at one
    iteration, within SIX_ITERS at six. Returns the launches and the
    numbers."""
    import torch.distributed as dist

    from pips_tpu_torch import chain_demo, demo, grid_queries, make_pips
    from pips_tpu_torch.evals import common, run_davis
    from pips_tpu_torch.inference.window import WindowTracker
    from pips_tpu_torch.parallel import (distributed_init, make_mesh, make_sharded_train_step,
                                         shard_batch)
    from pips_tpu_torch.train import make_optimizer, make_train_step

    launched, numbers = {"chan_ff_block": 0, "chan_ff_bwd": 0}, {}
    t0 = time.perf_counter()

    # (a) a JAX checkpoint of the seeded weights, read back by the port
    sd = seeded_weights(torch)
    ckpt = write_jax_checkpoint(torch, np, sd, root / "jax_ckpt", 7).parent
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = common.load_params(common.make_pips(dtype="bfloat16"), str(ckpt)).state_dict()
    read_s = time.perf_counter() - t
    bad = [k for k in sd if not torch.equal(got[k].cpu(), sd[k])]
    if sorted(got) != sorted(sd) or bad:
        fail(f"modules: load_params of the JAX msgpack checkpoint differs at {bad[:5]}")
    mb = (ckpt / "model-000000007.msgpack").stat().st_size / 1e6
    log("modules", f"a JAX msgpack checkpoint ({len(sd)} leaves, {mb:.1f} MB) read by "
                   f"load_params in {read_s:.2f} s, bit for bit")
    numbers["msgpack read s"] = read_s

    # (b) the demos on seeded noise jpgs
    images = root / "jpgs"
    images.mkdir()
    rng = np.random.RandomState(31)
    save_frames([(images / f"{i:05d}.jpg", data_frame(np, rng, *DEMO_HW))
                 for i in range(DEMO_FRAMES)])

    def run(main_fn, **kw):
        """A demo's ``main`` on the jpgs; (its result, its windows' seconds,
        chan_ff_block launches, seconds in all, seconds in load_params and in
        write_gif)."""
        mod = sys.modules[main_fn.__module__]
        parts = {"load_params": [], "write_gif": []}
        real = {name: getattr(mod, name) for name in parts}

        def timed(name):
            def call(*a, **k):
                t = time.perf_counter()
                out = real[name](*a, **k)
                parts[name].append(time.perf_counter() - t)
                return out
            return call

        torch.cuda.synchronize()
        mixer_cuda.launches = 0
        t = time.perf_counter()
        try:
            for name in parts:
                setattr(mod, name, timed(name))
            with timed_windows(torch, WindowTracker) as secs, \
                    contextlib.redirect_stdout(io.StringIO()):
                out = main_fn(init_dir=str(ckpt), images_dir=str(images), bf16=True,
                              resize_hw=DEMO_RESIZE, **kw)
            torch.cuda.synchronize()
        finally:
            for name, fn in real.items():
                setattr(mod, name, fn)
        return (out, secs, mixer_cuda.launches, time.perf_counter() - t,
                sum(parts["load_params"]), sum(parts["write_gif"]))

    window = DEPTH * ITERS
    out, secs, n_ff, run_s, load_s, gif_s = run(demo.main, out_dir=str(root / "demo"),
                                                max_chunks=DEMO_CHUNKS)
    xys = grid_queries(*DEMO_RESIZE)[0]
    gifs = sorted(p.name for p in (root / "demo").glob("*.gif"))
    if len(secs) != DEMO_CHUNKS or n_ff != window * DEMO_CHUNKS or len(gifs) != DEMO_CHUNKS:
        fail(f"demo: {len(secs)} windows, {n_ff} chan_ff_block launches, GIFs {gifs}")
    for tr in out["trajs"]:
        if not (np.isfinite(tr).all() and np.array_equal(tr[0], xys)):
            fail("demo: a trajectory is not finite, or frame 0 is not at its query")
    launched["chan_ff_block"] += n_ff
    pf = len(xys) * 8 / statistics.median(out["seconds"])
    log("modules", f"demo: {DEMO_CHUNKS} chunks of 8 at {DEMO_RESIZE}, {len(xys)} points, bf16: "
                   f"{run_s:.2f} s (weights {load_s:.2f}, GIFs {gif_s:.2f}); windows "
                   f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms; {pf:.0f} points*frames/s; "
                   f"{n_ff} chan_ff_block launches; GIFs {gifs}")
    numbers.update({"demo s": run_s, "demo window_ms": [s * 1e3 for s in secs],
                    "demo points*frames/s": pf})

    qs = grid_queries(*DEMO_RESIZE, DEMO_CHAIN_GRID, DEMO_CHAIN_GRID)[0]
    chains = {}
    for mode in ("default", "on_device", "stream"):
        out, secs, n_ff, run_s, load_s, gif_s = run(chain_demo.main,
                                                    out_dir=str(root / f"chain_{mode}"),
                                     grid=DEMO_CHAIN_GRID, max_frames=DEMO_FRAMES,
                                     **({mode: True} if mode != "default" else {}))
        trajs, vis = out["trajs"], out["vis"]
        windows = n_ff // window if mode == "on_device" else len(secs)
        if n_ff != window * windows or not windows:
            fail(f"chain_demo {mode}: {n_ff} chan_ff_block launches for {windows} windows")
        if trajs.shape != (DEMO_FRAMES, len(qs), 2) or not (
                np.isfinite(trajs).all() and np.isfinite(vis).all()
                and np.array_equal(trajs[0], qs)):
            fail(f"chain_demo {mode}: shapes {trajs.shape}, or not finite, or frame 0 off its "
                 f"query")
        if not (root / f"chain_{mode}" / "chain_out.gif").is_file():
            fail(f"chain_demo {mode}: no GIF")
        launched["chan_ff_block"] += n_ff
        chains[mode] = (trajs, vis)
        pf = len(qs) * DEMO_FRAMES / out["seconds"]
        numbers.update({f"chain_demo {mode} s": run_s,
                        f"chain_demo {mode} track s": out["seconds"],
                        f"chain_demo {mode} points*frames/s": pf})
        log("modules", f"chain_demo {mode}: {DEMO_FRAMES} frames at {DEMO_RESIZE}, {len(qs)} "
                       f"points, "
                       f"bf16: {windows} windows, {n_ff} chan_ff_block launches; tracking "
                       f"{out['seconds']:.3f} s ({pf:.0f} points*frames/s); {run_s:.2f} s in "
                       f"all (weights {load_s:.2f}, GIF {gif_s:.2f})")
    d_stream = drift(np, *chains["stream"], *chains["default"])
    d_dev = drift(np, *chains["on_device"], *chains["default"])
    log("modules", f"chain_demo stream vs default: {fmt(d_stream)}; on_device vs default: "
                   f"{fmt(d_dev)}")
    if d_stream["max"] > EXACT_PX or d_stream["vis_max"] > EXACT_PX:
        fail(f"chain_demo --stream differs from the default beyond {EXACT_PX}: {d_stream}")
    exact = d_dev["max"] <= EXACT_PX and d_dev["vis_max"] <= EXACT_PX
    if not exact and not (d_dev["median"] < SIX_ITERS["median"] and d_dev["p90"] <
                          SIX_ITERS["p90"] and d_dev["vis_median"] < SIX_ITERS["vis_median"]):
        fail(f"chain_demo --on_device differs from the default beyond phase 6's bounds: {d_dev}")
    if not exact:
        log("modules", f"chain_demo --on_device: past {EXACT_PX} px but within {SIX_ITERS}: "
                       f"the visibility rule took another start for some point")

    # (c) world size 1 over NCCL
    bf16 = torch.bfloat16
    distributed_init(device="cuda")
    probe = torch.ones(1, device="cuda")
    dist.all_reduce(probe)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1 or probe.item() != 1.0:
        fail(f"mesh: a group of one over {dist.get_backend()}, all_reduce gave {probe.item()}")
    try:
        mesh = make_mesh((1, 1))
        batch = train_batch(torch, np, TRAIN, seed=0)
        models = [make_pips(device="cuda", seed=0, dtype=bf16, fuse_chanff=True).train()]
        models.append(copy.deepcopy(models[0]))
        opts = [make_optimizer(m.parameters(), lr=5e-4, num_steps=10) for m in models]
        sharded = make_sharded_train_step(models[0], opts[0], mesh, iters=TRAIN["iters"],
                                          horz_flip=False, vert_flip=False)
        plain = make_train_step(models[1], opts[1], iters=TRAIN["iters"], horz_flip=False,
                                vert_flip=False)
        shard = shard_batch(mesh, batch)
        runs = {"sharded": [], "plain": []}
        for i in range(4):  # the first pair held against each other, all timed in turns
            for name, fn, arg in (("sharded", sharded, shard), ("plain", plain, batch)):
                zero_train_counts(mixer_cuda, corr_cuda)
                torch.cuda.synchronize()
                t = time.perf_counter()
                met = fn(arg)
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t) * 1e3)
                got_n = train_counts(mixer_cuda, corr_cuda)
                if got_n != step_launches(torch, bf16, TRAIN["iters"]):
                    fail(f"mesh: the {name} step launched {TRAIN_KERNELS} {got_n} times")
                if name == "sharded":
                    launched["chan_ff_block"] += got_n[0]
                    launched["chan_ff_bwd"] += got_n[1]
                if i == 0:
                    model = models[0 if name == "sharded" else 1]
                    runs[f"{name} first"] = (met, {n: p.grad.detach().float().clone()
                                                   for n, p in model.named_parameters()})
        r = grad_parity(torch, runs["sharded first"], runs["plain first"])
        bad = {k: r[k] for k, b in PARITY.items() if (r[k] > b if k == "loss_rel" else r[k] < b)}
        ms = {k: statistics.median(runs[k][1:]) for k in ("sharded", "plain")}
        log("modules", f"world size 1 over NCCL: sharded bf16 step (B={TRAIN['B']} N={TRAIN['N']} "
                       f"I={TRAIN['iters']} {TRAIN['H']}x{TRAIN['W']}) vs the one-process step: "
                       f"loss rel {r['loss_rel']:.3g}, global cos {r['global_cos']:.7f}, worst "
                       f"leaf cos {r['leaf_cos']:.7f}; {ms['sharded']:.1f} ms vs {ms['plain']:.1f} "
                       f"ms (median of 3, in turns)")
        if bad:
            fail(f"mesh: the sharded step differs from the one-process step beyond {PARITY}: {bad}")
        numbers.update({"world 1 sharded step ms": ms["sharded"],
                        "world 1 plain step ms": ms["plain"]})
        del models, opts, sharded, plain, runs
        torch.cuda.empty_cache()

        make_davis_tree(np, root / "davis", videos=1)
        trajs = {}
        for arg in ("auto", ""):
            mixer_cuda.launches = 0
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trajs[arg] = run_davis.main(init_dir=str(ckpt), davis_dir=str(root / "davis"),
                                            chunk=0, dtype="bfloat16", mesh=arg)["trajs"]
            if mixer_cuda.launches != window:
                fail(f"run_davis --mesh {arg!r}: {mixer_cuda.launches} chan_ff_block launches")
            if arg:
                launched["chan_ff_block"] += mixer_cuda.launches
            numbers[f"run_davis mesh {arg!r} s"] = time.perf_counter() - t
        d = float(np.abs(trajs["auto"] - trajs[""]).max())
        log("modules", f"run_davis --mesh auto vs --mesh '' on one 8-frame video, "
                       f"{EVAL_DAVIS_POINTS} points: max |diff| {d:.3g} px")
        if not np.isfinite(trajs["auto"]).all() or d > EXACT_PX:
            fail(f"run_davis --mesh auto differs from --mesh '' by {d} px")
    finally:
        dist.destroy_process_group()

    # (d) two ranks on the card over gloo
    t = time.perf_counter()
    ranks = run_two_ranks(np)
    bad = []

    def cmp(r):
        return (f"loss rel {r['loss_rel']:.3g}, global cos {r['global_cos']:.8f}, worst leaf cos "
                f"in the encoder {r['encoder_cos']:.7f}, outside {r['mixer_cos']:.7f}")

    def beyond(r, bounds):
        return {b: r[b] for b, v in bounds.items() if (r[b] > v if b == "loss_rel" else r[b] < v)}

    for dtype, w in ranks[0]["split_vs_one"].items():
        log("modules", f"one process, no collective: the two B=1 halves' {dtype} step "
                       f"(split_step) vs the B=2 step: {cmp(w)}; sample 0's encoder features "
                       f"alone vs in the batch: max |diff| {w['encode_rel']:.3g} of their "
                       f"largest value")
        if dtype == "float32" and beyond(w, MESH_F32):
            bad.append(f"split_step in f32 differs from the one-process step: "
                       f"{beyond(w, MESH_F32)}")
    one_vs_f32 = ranks[0]["single_vs_f32"]
    for k, r in enumerate(ranks[0]["steps"]):
        msg = (f"two ranks over gloo, mesh {tuple(r['shape'])}, {r['dtype']} step (B="
               f"{MESH_TRAIN['B']} N={MESH_TRAIN['N']} I={r['iters']} {MESH_TRAIN['H']}x"
               f"{MESH_TRAIN['W']}) vs the one-process step: {cmp(r)}")
        f32 = r["dtype"] == "float32"
        if "vs_split" in r:
            msg += f"; vs split_step: {cmp(r['vs_split'])}"
        off = beyond(r if f32 else r.get("vs_split", r), MESH_F32 if f32 else PARITY)
        if not f32:
            msg += f"; the one-process bf16 step vs the f32 one: {cmp(one_vs_f32[str(r['iters'])])}"
        log("modules", f"{msg}; step {r['ms']:.1f} ms on rank 0, "
                       f"{ranks[1]['steps'][k]['ms']:.1f} on rank 1, {r['peak_gb']:.2f} GB")
        if off:
            bad.append(f"mesh {r['shape']} {r['dtype']} I={r['iters']}: {off}")
        label = f"gloo {r['dtype']} I={r['iters']} mesh {r['shape'][0]}x{r['shape'][1]} step ms"
        numbers[label] = [rank["steps"][k]["ms"] for rank in ranks]
    for k, w in enumerate(ranks[0]["windows"]):
        log("modules", f"two ranks over gloo, point-split f32 window at (1, 2), N=256 at "
                       f"{MESH_WINDOW_HW[0]}x{MESH_WINDOW_HW[1]}, I={w['iters']}, vs unsplit: traj "
                       f"max {w['max']:.3g} px, median {w['median']:.3g}, p90 {w['p90']:.3g}; "
                       f"vis max "
                       f"{w['vis_max']:.3g} (the points moved up to {w['moved']:.3g} px); "
                       f"{w['ms']:.1f} ms")
        ok = (w["max"] <= EXACT_PX and w["vis_max"] <= EXACT_PX if w["iters"] == 1 else
              w["median"] < SIX_ITERS["median"] and w["p90"] < SIX_ITERS["p90"])
        if not (ok and all(rank["windows"][k]["finite"] for rank in ranks)):
            bad.append(f"the point-split window at I={w['iters']} differs from the unsplit "
                       f"one: {w}")
        numbers[f"gloo window I={w['iters']} ms"] = w["ms"]
    r0 = ranks[0]
    log("modules", f"two ranks: {time.perf_counter() - t:.1f} s; in rank 0 ready (imports, CUDA, "
                   f"the group, the batch) at {r0['ready_s']:.1f} s, models built at "
                   f"{', '.join(f'{v:.1f}' for v in r0['built_s'])} s, one-process steps done at "
                   f"{', '.join(f'{v:.1f}' for v in r0['ref_s'])} s, the mesh steps at "
                   f"{', '.join(f'{v['at_s']:.1f}' for v in r0['steps'])} s, the windows at "
                   f"{r0['end_s']:.1f} s")
    if bad:
        fail("; ".join(bad))
    numbers["phase_s"] = time.perf_counter() - t0
    return dict(launched=launched, **numbers)


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
                                        row_contract_cuda, stem_wgrad_cuda, token_cuda)
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

    def kernel_counts():
        """Every kernel's launch count, as zero_counts zeroes them."""
        return {"chan_ff_block": mixer_cuda.launches, "chan_ff_bwd": mixer_cuda.bwd_launches,
                "chan_ff_bwd_f32": mixer_cuda.bwd_f32_launches,
                "chan_ff_chunked_fwd": chanff_chunk_cuda.launches,
                "chan_ff_chunked_bwd": chanff_chunk_cuda.bwd_launches,
                "corr_sample": corr_cuda.launches, "conv3x3_same": conv_cuda.launches,
                "res_block64": block_cuda.launches, "stem_wgrad": stem_wgrad_cuda.launches,
                "mixer_probes": sum(mixer_probes_cuda.launches.values()),
                "corr_rows": corr_rows_cuda.launches,
                "row_contract": sum(row_contract_cuda.launches.values())}

    # launches summed over main-path runs
    main_path = {"chan_ff_block": 0, "corr_sample": 0, "chan_ff_bwd": 0, "conv3x3_same": 0,
                 "conv3x3_f32": 0, "res_block64": 0, "res_block64_f32": 0, "stem_wgrad": 0,
                 "stem_wgrad_f32": 0, "chan_ff_bwd_f32": 0,
                 "chan_ff_chunked_fwd": 0, "chan_ff_chunked_bwd": 0, "gelu": 0, "ln_slice": 0,
                 "stream_accum": 0, "corr_rows": 0, "row_contract_a": 0, "row_contract_a2": 0,
                 "row_contract_b": 0, "row_contract_c": 0, "token_mix_block": 0}

    def token_window(name, window):
        """``window()``'s result, after checking that it took the token
        kernel in each of its DEPTH * ITERS mixer blocks and never the plain
        version; the launches count for the main path."""
        before = token_cuda.launches, token_cuda.plain_calls
        result = window()
        got = token_cuda.launches - before[0], token_cuda.plain_calls - before[1]
        if got != (DEPTH * ITERS, 0):
            fail(f"{name}: the token half took the kernel and the plain version {got} times, "
                 f"expected {(DEPTH * ITERS, 0)}")
        main_path["token_mix_block"] += got[0]
        return result

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
    for stem, kernel in PTXAS_REPORT:
        report = ptxas_report(Path(info[stem]["path"]).with_suffix(".log"), kernel)
        log("build", f"{kernel} ({stem}.cu): {report}")
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
        if kernel in NO_SPILLS and any(int(n) for n in spills):
            fail(f"ptxas spills registers in {kernel}: {report}")

    # 3a. chan_ff_block against its plain version, at the main path's shapes:
    # the served windows' (R_MAIN, and 2000, no multiple of the kernels' row
    # tiles), the dense window's (bf16), the train paths' (the training
    # default; the bench train shape in f32) and an edge R that fills no row
    # tile; a repeat gives the same bits, and one call launches its plan's
    # kernels, captured in a CUDA graph; then the same at the Pips2 refiner's
    # D=256, F=1024 (PIPS2_RS)
    require_full_f32(torch)
    R_MAIN = 1 * 256 * 8  # B*N*S of the first request
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chanff = {}
    for D, F_ in ((512, 2048), (PIPS2_D, PIPS2_F)):
        fwd_cases = {}
        for dtype in ("bfloat16", "float32"):
            rows = (DENSE_R,) if dtype == "bfloat16" else (TRAIN_R,)
            rows = (R_MAIN, 2000, TRAIN_R_DEFAULT) + rows + (EDGE_R,) if D == 512 else PIPS2_RS
            for R in rows:
                args = chanff_args(torch, np, R, getattr(torch, dtype), seed=R, D=D, F=F_)
                y = mixer_cuda.chan_ff_block(*args)
                torch.cuda.synchronize()
                ref = mixer_cuda.chan_ff_reference(*args)
                err = (y.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                tol = bf16_tol(ref_max) if dtype == "bfloat16" else TOL_F32
                if not torch.equal(y, mixer_cuda.chan_ff_block(*args)):
                    fail(f"chan_ff_block {dtype} D={D} R={R}: two calls on the same inputs differ")
                n = 20 if R < TRAIN_R_DEFAULT else 5
                ms = median_ms(torch, mixer_cuda.chan_ff_block, args, launches=n)
                plain_ms = median_ms(torch, mixer_cuda.chan_ff_reference, args, launches=n)
                bound_ms, bound_by = chanff_bound(R, dtype, D, F_)
                split = mixer_cuda.fwd_plan(R, F_, args[0].dtype, sms, D).split
                log("kernels", f"chan_ff_block {dtype} D={D} F={F_} R={R}: max_abs_err {err:.3g} "
                               f"(tol {tol:.3g}, |y| <= {ref_max:.3g}); repeat bit-identical; "
                               f"split {split}; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                               f"{bound_ms:.4f} ms ({bound_by})")
                if not (y.shape == ref.shape and err <= tol):
                    fail(f"chan_ff_block {dtype} D={D} R={R} disagrees with its plain version: "
                         f"{err} > {tol}")
                chanff[(dtype, R, D)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound_ms, bound_by=bound_by)
                fwd_cases[(dtype, R)] = args
                del y, ref
        fwd_launches_match_plans(torch, mixer_cuda, fwd_cases, f"chan_ff_block D={D}")
        del fwd_cases
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
            one_kernel_call(torch, corr_cuda.corr_sample, args, out, corr_cuda.KERNEL,
                            f"corr_sample {case} {map_dt}/{tgt_dt}")
            corr[(case, map_dt, tgt_dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                bound_ms=bound_ms, bound_by=bound_by)
            del args, out, ref, tol, diff
    # the edges: against the plain version, repeats bit-identical, one kernel a call
    for case, N, H8, W8, where in CORR_EDGES:
        parts = []
        for map_dt, tgt_dt in CORR_PAIRS:
            args = corr_args(torch, np, N, H8, W8, map_dt, tgt_dt, seed=N + H8, where=where)
            out = corr_cuda.corr_sample(*args)
            torch.cuda.synchronize()
            ref = corr_cuda.corr_sample_reference(*args)
            diff = (out - ref).abs()
            ratio = (diff / corr_tol(corr_cuda, *args).clamp_min(1e-30)).max().item()
            zero = where in ("off", "huge")  # no tap on any map: every output is zero
            if not (out.shape == ref.shape and ratio <= 1.0
                    and (not zero or not out.abs().max().item())):
                fail(f"corr_sample edge {case} {map_dt}/{tgt_dt} disagrees with its plain "
                     f"version (worst err/tol {ratio:.3g}, |out| <= {out.abs().max().item()})")
            one_kernel_call(torch, corr_cuda.corr_sample, args, out, corr_cuda.KERNEL,
                            f"corr_sample edge {case} {map_dt}/{tgt_dt}")
            parts.append(f"{map_dt}/{tgt_dt} err/tol {ratio:.3g}")
            del args, out, ref, diff
        log("kernels", f"corr_sample edge {case} (N={N}, {H8}x{W8}, levels "
                       f"{[(H8 >> k, W8 >> k) for k in range(4)]}): " + "; ".join(parts)
                       + f"; repeats bit-identical, one {corr_cuda.KERNEL} a call")
    torch.cuda.empty_cache()

    # 3c. chan_ff_bwd against its plain version: the bench train shape
    # (B*N*S = 1*128*8), the training default (4*768*8 after both flips), a
    # ragged R that is no multiple of the kernels' 128-row tiles and an edge
    # R that fills none; a repeat gives the same bits, and one call launches
    # its plan's kernels, captured in a CUDA graph; then the same at the Pips2
    # refiner's D=256, F=1024 (PIPS2_RS)
    chanff_bwd = {}
    for D, F_, rows in ((512, 2048, (TRAIN_R, TRAIN_R_DEFAULT, 800, EDGE_R)),
                        (PIPS2_D, PIPS2_F, PIPS2_RS)):
        bwd_cases = {}
        for R in rows:
            args = chanff_bwd_args(torch, np, R, seed=R, D=D, F=F_)
            out = mixer_cuda.chan_ff_bwd(*args)
            torch.cuda.synchronize()
            ref = mixer_cuda.chan_ff_bwd_reference(*args)
            tols = chanff_bwd_tols(torch, mixer_cuda, args)
            worst, parts, max_err = grad_errors(torch, f"chan_ff_bwd D={D} R={R}", out, ref, tols)
            bwd_repeat(torch, mixer_cuda, args, out, f"chan_ff_bwd D={D} R={R}")
            parts.append("repeat bit-identical")
            n = 20 if R <= TRAIN_R_DEFAULT else 5
            ms = median_ms(torch, mixer_cuda.chan_ff_bwd, args, launches=n)
            plain_ms = median_ms(torch, mixer_cuda.chan_ff_bwd_reference, args, launches=n)
            bound_ms, bound_by = chanff_bwd_bound(R, "bfloat16", D, F_)
            log("kernels", f"chan_ff_bwd bf16 D={D} F={F_} R={R}: max_abs_err " + "; ".join(parts)
                           + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                             f"({bound_by})")
            if worst > 1.0:
                fail(f"chan_ff_bwd D={D} R={R} disagrees with its plain version (worst err/tol "
                     f"{worst:.3g})")
            chanff_bwd[(R, D)] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            bwd_cases[R] = args
            del out, ref, tols
        bwd_launches_match_plans(torch, mixer_cuda, bwd_cases, f"chan_ff_bwd bf16 D={D}")
        del bwd_cases
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
        # the kernel's own operands (a weight already in x's dtype and
        # contiguous), so that the call enqueues the conv and nothing else
        for name, args in (("y", (x, w.to(x.dtype), b)), ("dx", (dy, w_rot.contiguous(), zero))):
            kernel = conv_cuda.launch_plan(B, 64, 64, H, W, x.dtype).kernel
            one_kernel_call(torch, conv_cuda.conv3x3_same, args, outs[name], kernel,
                            f"conv3x3_same {case} {name}")
        parts.append(f"repeats bit-identical, one {kernel} a call")
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
        before = F32_BEFORE_MS["conv3x3_f32"].get(case)
        log("kernels", f"conv3x3_same {case} {B}x64x{H}x{W} {dtype} channels_last: max_abs_err "
                       + "; ".join(parts) + f"; {k1:.4f}/{k2:.4f} ms, F.conv2d {l1:.4f}/{l2:.4f} "
                       f"ms (in turns), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})" + (f", the SIMT kernel before {before:.4f} ms"
                                          if before else ""))
        conv[case] = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        del x, w, b, dy, w_rot, outs, refs
    # other widths: the mma.sync kernel, forward and dx, timed in turns with F.conv2d
    for case, B, H, W, C, O in CONV_WIDTHS:
        x, w, b, dy = conv_args(torch, np, B, H, W, "bfloat16", seed=B + H + C, C=C, O=O)
        w_rot = w.to(x.dtype).flip(2, 3).transpose(0, 1)
        zero = torch.zeros(C, device="cuda")
        parts = []
        for name, args, cin, cout in (("y", (x, w.to(x.dtype), b), C, O),
                                      ("dx", (dy, w_rot.contiguous(), zero), O, C)):
            out = conv_cuda.conv3x3_same(*args)
            torch.cuda.synchronize()
            ref = conv_cuda.conv3x3_reference(*args)
            err = (out.float() - ref.float()).abs().max().item()
            tol = bf16_tol(ref.float().abs().max().item())
            if not (out.shape == ref.shape and err <= tol
                    and out.is_contiguous(memory_format=torch.channels_last)):
                fail(f"conv3x3_same {case} {name} disagrees with its plain version: {err} > {tol}")
            kernel = conv_cuda.launch_plan(B, cin, cout, H, W, x.dtype).kernel
            one_kernel_call(torch, conv_cuda.conv3x3_same, args, out, kernel,
                            f"conv3x3_same {case} {name}")
            parts.append(f"{name} {err:.3g} (tol {tol:.3g}), one {kernel} a call")
        wl, bl = w.to(x.dtype), b.to(x.dtype)

        def library():
            return F.conv2d(x, wl, bl, padding=1)

        k1 = median_ms(torch, conv_cuda.conv3x3_same, (x, w, b))
        l1 = median_ms(torch, library, ())
        k2 = median_ms(torch, conv_cuda.conv3x3_same, (x, w, b))
        l2 = median_ms(torch, library, ())
        bound_ms, bound_by = conv_bound(B, H, W, "bfloat16", C=C, O=O)
        log("kernels", f"conv3x3_same {case} {B}x{C}->{O}x{H}x{W} bfloat16 channels_last: "
                       + "; ".join(parts) + f"; repeats bit-identical; {k1:.4f}/{k2:.4f} ms, "
                       f"F.conv2d {l1:.4f}/{l2:.4f} ms (in turns), bound {bound_ms:.4f} ms "
                       f"({bound_by})")
        del x, w, b, dy, w_rot, out, ref
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

    # 3j. the mixer's token half, LN -> token FF -> residual in one kernel
    token = phase_token(torch, np, token_cuda)

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
        trajs, vis = token_window(name, lambda: tracker(xys, rgbs))
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

    # the same window in f32 (``--dtype float32 --fuse_conv3 1``): the four
    # stage-1 convs through the f32 kernel, against the same f32 weights
    # without it (cuDNN in full f32), held to the same drift bounds
    if conv_cuda.launch_plan(8, 64, 64, H // 2, W // 2, torch.float32).kernel != "conv3x3_f32":
        fail("the f32 window's stage-1 conv does not plan the f32 kernel")
    model32 = make_pips(device="cuda", seed=0, dtype=torch.float32, fuse_chanff=True)
    model32_c = make_pips(device="cuda", seed=0, dtype=torch.float32, fuse_chanff=True,
                          fuse_conv3=True)
    trackers32 = {k: {n: WindowTracker(m, iters=n, corr_mode="onehot") for n in (1, ITERS)}
                  for k, m in (("plain convs", model32), ("fuse_conv3", model32_c))}
    plain6 = trackers32["plain convs"][ITERS](xys, rgbs)
    zero_counts()
    c_trajs, c_vis = trackers32["fuse_conv3"][ITERS](xys, rgbs)
    n_conv, n_ff = conv_cuda.launches, mixer_cuda.launches
    check_window(np, f"f32 fuse_conv3 {name}", c_trajs, c_vis, xys)
    if n_conv != CONV_PER_ENCODE or n_ff != DEPTH * ITERS:
        fail(f"f32 fuse_conv3 {name}: conv3x3_f32 launched {n_conv} and chan_ff_block {n_ff} "
             f"times, expected {CONV_PER_ENCODE} and {DEPTH * ITERS}")
    main_path["conv3x3_f32"] += n_conv
    one = drift(np, *trackers32["fuse_conv3"][1](xys, rgbs),
                *trackers32["plain convs"][1](xys, rgbs))
    six = drift(np, c_trajs, c_vis, *plain6)
    times = {"plain convs": [], "fuse_conv3": []}
    for _ in range(7):
        for k in times:
            times[k].append(window_seconds(torch, trackers32[k][ITERS], xys, rgbs))
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    log("slice", f"f32 fuse_conv3 {name}: {n_conv} conv3x3_f32 + {n_ff} chan_ff launches; vs "
                 f"plain convs: 1 iter traj max {one['max']:.3g} px, vis max {one['vis_max']:.3g}; "
                 f"6 iters {fmt(six)}; median window over 7, in turns: plain convs "
                 f"{med['plain convs']:.2f} ms, fuse_conv3 {med['fuse_conv3']:.2f} ms (host clock)")
    check_drift(f"f32 fuse_conv3 {name}", one, six)
    window_ms["f32 fuse_conv3 " + name] = med
    del model32, model32_c, trackers32
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
        trajs, vis = token_window(name, lambda: tracker_p(xys, rgbs))
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
    tok = token_cuda.launches, token_cuda.plain_calls
    train_default, got = timed_steps(torch, mixer_cuda, corr_cuda, train_model, big, bf16, 3,
                                     "train")
    add_launches(main_path, got)
    # autograd records in every step, so the token half takes its plain
    # version: DEPTH * iters calls a step at least (remat's recompute adds more)
    n_tok, n_plain = token_cuda.launches - tok[0], token_cuda.plain_calls - tok[1]
    log("train", f"token half over the 4 default steps: {n_tok} kernel calls, {n_plain} plain "
                 f"calls ({n_plain / 4:.0f} a step)")
    if n_tok or n_plain < 4 * DEPTH * TRAIN_DEFAULT["iters"]:
        fail(f"4 default train steps took the token kernel {n_tok} and the plain version "
             f"{n_plain} times, expected 0 and at least {4 * DEPTH * TRAIN_DEFAULT['iters']}")

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

    # 10. slice: the Pips2 (PIPs++) family, its channel blocks the kernels at
    # D=256 (and at the loop's default refiner, D=512): windows, a chain, a
    # parity step, the train loop and timed steps
    zero_counts()
    pips2 = phase_pips2(torch, np, mixer_cuda, corr_cuda, build_dir)
    for k, n in pips2.pop("launched").items():
        main_path[k] += n

    # 11. slice: the data path, the host library and the FlyingThings++ and
    # PointOdyssey readers feeding train.loop.main at the loop's defaults
    zero_counts()
    data = phase_data(torch, np, mixer_cuda, corr_cuda, build_dir)
    for k, n in data.pop("launched").items():
        main_path[k] += n

    # 12. slice: the eval runners, bf16 (the channel-block kernel) and f32, on
    # a reference-format checkpoint; 13. the RAFT and DINO baselines through
    # the same runners on the same trees, which launch no kernel of the port
    eval_root = Path(tempfile.mkdtemp(prefix="chip_smoke_evals_", dir=build_dir))
    try:
        zero_counts()
        evals = phase_evals(torch, np, mixer_cuda, mixer_module, eval_root)
        for k, n in evals.pop("launched").items():
            main_path[k] += n
        t13 = time.perf_counter()
        baselines = phase_baselines(torch, np, eval_root, zero_counts, kernel_counts)
        baselines["phase_s"] = time.perf_counter() - t13
    finally:
        shutil.rmtree(eval_root, ignore_errors=True)
    log("evals", f"{smi}: " + "; ".join(
        f"{name} {evals[f'{name} s']:.2f} s, window first {evals[f'{name} first_window_ms']:.1f}"
        f" ms, then {evals[f'{name} window_ms_median']:.1f}"
        for name in ("flt bf16", "flt f32", "crohd bf16", "badja bf16", "davis bf16 chunk 0",
                     "davis bf16 chunk 256"))
        + "; DAVIS TPS steady (runner's mean) " + ", ".join(
            f"{evals[f'davis bf16 chunk {c} steady_tps']:.0f} "
            f"({evals[f'davis bf16 chunk {c} tps']:.0f}) at chunk {c}" for c in EVAL_DAVIS_CHUNKS))

    # 14. the last modules: the JAX checkpoint reader, the demos and parallel/
    modules_root = Path(tempfile.mkdtemp(prefix="chip_smoke_modules_", dir=build_dir))
    try:
        zero_counts()
        modules = phase_modules(torch, np, mixer_cuda, corr_cuda, modules_root)
    finally:
        shutil.rmtree(modules_root, ignore_errors=True)
    for k, n in modules.pop("launched").items():
        main_path[k] += n
    log("modules", f"{smi}: phase 14 {modules['phase_s']:.1f} s")

    log("baselines", f"{smi}: phase 13 {baselines['phase_s']:.1f} s; " + "; ".join(
        f"{name} {baselines[f'{name} s']:.2f} s, window first "
        f"{baselines[f'{name} first_window_ms']:.1f} ms, then "
        f"{baselines[f'{name} window_ms_median']:.1f}, peak {baselines[f'{name} peak_gb']:.2f} GB"
        for name in (f"{r} {m}" for m in ("raft", "dino") for r in ("flt", "badja", "crohd"))))

    log("slice", f"main-path launches: {main_path}")
    if min(main_path.values()) == 0:
        fail(f"a kernel of the path never launched on it: {main_path}")
    print(smi, flush=True)  # again, so that the tail of the log holds the card and its limit
    main_ff = chanff[("bfloat16", R_MAIN, 512)]
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
         "launches": main_path["chan_ff_bwd"], **chanff_bwd[(TRAIN_R_DEFAULT, 512)],
         "library_ms": None},
        {"name": "conv3x3_same", "route": "cuda", "source": "pips_tpu_torch/csrc/conv3x3_fwd.cu",
         "replaces": "pips_tpu/kernels/conv_pallas.py:148",
         "launches": main_path["conv3x3_same"], **conv["window"]},
        {"name": "conv3x3_f32", "route": "cuda", "source": "pips_tpu_torch/csrc/conv3x3_fwd.cu",
         "replaces": "pips_tpu/kernels/conv_pallas.py:148",
         "launches": main_path["conv3x3_f32"], **conv["window f32"]},
        {"name": "res_block64", "route": "cuda", "source": "pips_tpu_torch/csrc/conv3x3_stats.cu",
         "replaces": "pips_tpu/kernels/block_pallas.py:110",
         "launches": main_path["res_block64"], **block["bench"]},
        {"name": "res_block64_f32", "route": "cuda",
         "source": "pips_tpu_torch/csrc/conv3x3_stats.cu",
         "replaces": "pips_tpu/kernels/block_pallas.py:110",
         "launches": main_path["res_block64_f32"], **block["bench f32"]},
        {"name": "stem_wgrad", "route": "cuda", "source": "pips_tpu_torch/csrc/stem_wgrad.cu",
         "replaces": "pips_tpu/kernels/stem_wgrad_pallas.py:97",
         "launches": main_path["stem_wgrad"],
         **{k: v for k, v in stem["B=8"].items() if k != "x7_ms"}},
        {"name": "stem_wgrad_f32", "route": "cuda", "source": "pips_tpu_torch/csrc/stem_wgrad.cu",
         "replaces": "pips_tpu/kernels/stem_wgrad_pallas.py:97",
         "launches": main_path["stem_wgrad_f32"],
         **{k: v for k, v in stem["B=8 f32"].items() if k != "x7_ms"}},
        {"name": "chan_ff_bwd_f32", "route": "cuda", "source": "pips_tpu_torch/csrc/chanff_bwd.cu",
         "replaces": "pips_tpu/kernels/mixer_pallas.py:245",
         "launches": main_path["chan_ff_bwd_f32"], **chanff_f32[(TRAIN_R_DEFAULT, 512)],
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
        for name, source, replaces in PROBE_KERNELS] + [
        {"name": "token_mix_block", "route": "cuda", "source": "pips_tpu_torch/csrc/token_ff.cu",
         "replaces": None, "launches": main_path["token_mix_block"],
         **token[("bfloat16", 7680)]}]}), flush=True)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f} s "
                f"(chained video {chain_s:.2f} s; windows {json.dumps(window_ms)}; "
                f"training default {json.dumps(train_default)}; f32 {json.dumps(train_f32)}; "
                f"Pips2 {json.dumps(pips2)}; data {json.dumps(data)}; evals {json.dumps(evals)}; "
                f"baselines {json.dumps(baselines)}; modules {json.dumps(modules)})")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
