"""Where the time of the pipelined kernels goes, on the card.

The bf16 ``stem_wgrad`` kernel (``csrc/stem_wgrad.cu``), ``stream_accum``
(``csrc/mixer_probes.cu``), the bf16 ``conv_pass`` (``csrc/conv3x3_stats.cu``),
``row_contract`` (``csrc/row_contract.cu``), the channel block's forward
and backward (``csrc/chanff_fwd.cu``, ``csrc/chanff_bwd.cu``, bf16 and f32),
the bf16 3x3 conv (``csrc/conv3x3_fwd.cu``) and the corr sampler
(``csrc/corr_sample_fwd.cu``) each overlap memory traffic with products.
No kernel profiler runs on the machine with the card, so this tool builds
variants of each source with one phase taken out (a change to the source or to a header it includes) and
times them beside the kernel, at the smoke's shapes: what a phase costs is
the time it adds. A variant's output is wrong by construction; only the
kernel's is held to its plain version.

    python3 -m pips_tpu_torch.tools.profile_pipelines

Variants of ``stem_wgrad`` (B=8 and B=1, 384x512, as many blocks as the
kernel takes): "kernel"; "no x copies" (the producers skip x2's rows); "no
products" (the warpgroup skips its wgmma); "dy only" (both); "no segments"
(no block gets a segment: the launch, the partial sums and the second
launch). Of its f32 kernel (B=8 and B=1 at 384x512 and the smoke's small
2x64x96, as ``f32_plan`` lays them out; beside ``conv2d_weight`` with TF32
off): "kernel"; "f32 no copies" (no cp.async: the products read stale
stages); "f32 no shared loads" (x and dy from the column index: the FMAs
stay); "f32 no products" (each group's column loop skipped); "f32 no
segments". Of ``stream_accum`` (``tools/debug_mixer_kernel.py``'s x (128, 4096)
and w1 (12, 512, 2048)): "kernel"; "no products"; "no copies" (the producer
only arrives, so the products read stale tiles). Of ``conv_pass`` (8x64x192x256
bf16, the prologue on; the kernel also with it off): "kernel"; "no input
copies" (the loads only arrive); "no products" (no wgmma); "no epilogue"
(no statistics, staging or stores). Of ``row_contract`` (probes A and C
of ``tools/probe_mosaic_ops.py``): "kernel"; "no copies" (no row is staged);
"no products" (no mma); "no cross-block sum" (each block writes its own
partial sums over the output); and "general path", the unmodified source's
SIMT branch on the same shapes (its products are FMAs walking the rows).
Of the channel block's backward (R=24,576, the training default, F=2048, in
bf16 and f32, one ``pips_chanff_bwd`` call): "kernel", with each of its
launches' device time under the profiler; "no activation products", "no dxa
products" and "no weight-grad products" (the consumers only wait for each
stage and release it; the epilogues run on zeros); and in bf16 "no copies"
(no TMA copy: the products read stale tiles). Of the channel block's forward
(the same R and F, bf16 and f32, one ``pips_chanff_fwd`` call as
``mixer_cuda.fwd_plan`` lays it out): "kernel", with each launch's device
time under the profiler; "no activation products" and "no out products" (as
the backward's); "no GELU" (the activation epilogue stores a1 + b1 as it
is); and in bf16 "no copies"; then two configurations, "one block an SM"
(the bf16 products one block an SM with six-stage rings, the first design)
and "f32 act two blocks an SM"; and the kernel at each split of the out
product (1, 2, 4) at R=100, 1024 and 2048, both dtypes, beside the plan's
choice. Of the F-chunked channel block's two kernels (``csrc/chanff_chunk.cu``,
``chanff_chunk_fwd`` and ``chanff_chunk_bwd_rows`` alone, without the
backward's finishing launches; at the tool's R=1024 with fc 512 and 1024 and
at R=24,576 with fc 512, as ``chunk_plan`` splits them): "kernel"; "no GELU"
(the epilogues take a for gelu(a) and dg1 for da1); "no activation products"
and "no out/dxa products" (the consumers only wait for each step and release
it); "no copies" (the producer only arrives: the products read stale tiles);
"no cluster sum" (each block adds only the first rank's partial tile); and
the kernel at each split its C entry takes there. Of the 3x3 conv's wgmma
kernel (``csrc/conv3x3_fwd.cu``, bf16 64 -> 64 at the window's, the training
default's and the bench train shape's stage 1; its products are
``csrc/conv3x3_tiles.cuh``'s, which ``conv_pass`` shares): "kernel", beside
``F.conv2d``; "no input copies" (the producer only arrives); "no products";
"no epilogue" (no staging or stores); and four tile configurations against
the kernel's 4 x 30 tiles, three consumer warpgroups and six ring slots (8 x
30 and 6 x 30 tiles with two or three warpgroups, 4 x 30 with two). Of the
corr sampler (``csrc/corr_sample_fwd.cu``, the smoke's flagship N=256 and
dense N=7680 inputs on 60x128 maps, each dtype pair): "kernel";
"no pixel loads" (the patch reads as zeros); "no products or dots"; "no
reduction" (the shuffles that sum half-pixels or reduce-scatter partial
dots); "no epilogue" (the 49 outputs not combined); "two blocks an SM" and
"three blocks an SM" (the launch bounds against the kernel's four); and the
kernel at one, two and four levels a warp. Of the f32 3x3 conv
(``conv3x3_f32``, whose mainloop ``csrc/conv3x3_f32_tiles.cuh`` the f32
``conv_pass`` shares; at the window's stage 1, 8x64x240x512, and at
2x64x31x70, as ``conv_cuda.launch_plan`` lays them out): "kernel", beside
``F.conv2d`` in f32 with TF32 off; "f32 no copies" (no box or weight copy:
the products read stale stages); "f32 no box copies"; "f32 no weight
copies"; "f32 no weight loads" (the products take their weights from the
loop's indices). ``python3 -m pips_tpu_torch.tools.profile_pipelines
conv3x3_fwd corr_sample_fwd`` builds and times those sources' variants
alone. Times: CUDA events around
``reps`` calls queued behind a sleep kernel (so the host's cost per call
hides), the median of ``rounds``. Prints one JSON line with the card's name
and power limit; needs CUDA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import torch

from pips_tpu_torch.kernels import (_build, block_cuda, chanff_chunk_cuda, mixer_cuda,
                                    row_contract_cuda)
from pips_tpu_torch.kernels.mixer_probes_cuda import stream_accum_reference
from pips_tpu_torch.kernels.stem_wgrad_cuda import stem_wgrad_reference
from pips_tpu_torch.tools import debug_mixer_kernel, probe_mosaic_ops

ROUNDS, REPS = 7, 20
STEM_X = ("for (int r = 0; r < KY; ++r) {\n        const uint32_t* src",
          "for (int r = 0; r < 0; ++r) {\n        const uint32_t* src")
STEM_MMA = ("          wgmma_m64n32k16_rs<1>(", "          if (ks < 0) wgmma_m64n32k16_rs<1>(")
STEM_NONE = ("const int n = (int)(s1 - s0);", "const int n = 0 * (int)(s1 - s0);")
# the f32 kernel (stem_wgrad_f32): its copies; its shared loads (x and dy
# taken from the column index instead, so the FMAs stay); its products (each
# group's column loop skipped: copies, barriers, the groups' sums and the
# second launch remain); every segment
STEM32_COPY = [("      cp_async_16z(st + 4 * i, dsrc + 4 * i, true);",
                "      if (i < 0) cp_async_16z(st + 4 * i, dsrc + 4 * i, true);"),
               ("        cp_async_8(st + kDyFloats + r * kXR * C",
                "        if (k < 0) cp_async_8(st + kDyFloats + r * kXR * C")]
STEM32_LDS = [("    x[ky] = *reinterpret_cast<const float2*>(xp + ky * kXR * C + w * C);",
               "    x[ky] = make_float2(__int_as_float(w + ky), __int_as_float(w));"),
              ("  const float4 d0 = *reinterpret_cast<const float4*>(dp + w * O);",
               "  const float4 d0 = make_float4(__int_as_float(w), __int_as_float(w + 1),\n"
               "                                __int_as_float(w + 2), __int_as_float(w + 3));"),
              ("  const float4 d1 = *reinterpret_cast<const float4*>(dp + w * O + 32);",
               "  const float4 d1 = make_float4(__int_as_float(w + 4), __int_as_float(w + 5),\n"
               "                                __int_as_float(w + 6), __int_as_float(w + 7));")]
STEM32_FMA = ("    int w = c0;", "    int w = c1;")
STEM32_NONE = ("  const int nsegs = s1 - s0;", "  const int nsegs = 0 * (s1 - s0);")
STEM32_CASES = (("B=8", 8, 384, 512), ("B=1", 1, 384, 512), ("small", 2, 64, 96))
SA_MMA = ("        wgmma_m64n64k16<0, 1>(acc,\n",
          "        if (ks < 0) wgmma_m64n64k16<0, 1>(acc,\n")
SA_COPY = [("        mbar_arrive_expect_tx(&full[s], kWTile + (i == 0 ? kXBytes : 0));",
            "        mbar_arrive(&full[s]);"),
           ("        for (int h = 0; i == 0 && h < kBK / 64; ++h)",
            "        for (int h = 0; i < 0 && h < kBK / 64; ++h)"),
           ("        tma_load_2d(ws + s * kWTile,",
            "        if (i < 0) tma_load_2d(ws + s * kWTile,")]
CONV_COPY = [("    mbar_arrive_expect_tx(&full[s], kBoxBytes);", "    mbar_arrive(&full[s]);"),
             ("    tma_load_4d(xs + s * kStageBytes,", "    if (i < 0) tma_load_4d(xs + s * kStageBytes,")]
CONV_MMA = ("      product<N>(acc,", "      if (tap < 0) product<N>(acc,")
# (the accumulators stay live: ptxas drops products whose results go unread)
CONV_EPI = ("    wgmma_wait<0>();\n",
            "    wgmma_wait<0>();\n    named_sync(2 + wg, 128);\n"
            "    if (ctid == 0) load(i + kWGs * kSlotsWG);\n"
            "    if (h0 < 0) part[tid] = acc[0] + acc[17] + acc[38] + acc[63];\n    continue;\n")
RC_COPY = ("  stage_rows(bs, as, &b_map, g * b_gstep + i0, rows_per, ag, n, CA, a_rs, bar);",
           "  if (tid == 0) mbar_arrive(bar);")
RC_MMA = ("  for (int ks = kg; kg < KG && ks < kp / 16; ks += 2 * KG) {",
          "  for (int ks = kg; kg < KG && ks < 0; ks += 2 * KG) {")
RC_SUM = ("  const int splits = gridDim.x, split = blockIdx.x;\n  const int tid",
          "  const int splits = 1, split = blockIdx.x;\n  const int tid")
CFB_ACT = ("    consume<0, 1>(ring, a1, 0, kSteps, wg);\n    consume<0, 0>(ring, dg, kSteps, 2 * kSteps, wg);\n",
           "    for (int i = 0; i < 2 * kSteps; ++i) {\n      ring.wait(i);\n      ring.release(i);\n    }\n")
CFB_DXA = ("    consume<0, 0>(ring, acc, 0, steps, wg);\n",
           "    for (int i = 0; i < steps; ++i) {\n      ring.wait(i);\n      ring.release(i);\n    }\n")
CFB_WGRAD = ("  consume<1, 1>(ring, acc, 0, i1 - i0, wg);\n",
             "  for (int i = 0; i < i1 - i0; ++i) {\n    ring.wait(i);\n    ring.release(i);\n  }\n")
CFB_COPY = [("    mbar_arrive_expect_tx(&full[s], kStageBytes);", "    mbar_arrive(&full[s]);"),
            ("  tma_load_2d(dst, map, k0, r0, bar);\n", "  if (k0 < 0) tma_load_2d(dst, map, k0, r0, bar);\n"),
            ("  tma_load_2d(dst, map, n0, k0, bar);\n  tma_load_2d(dst + kBox, map, n0 + 64, k0, bar);\n",
             "  if (k0 < 0) {\n    tma_load_2d(dst, map, n0, k0, bar);\n"
             "    tma_load_2d(dst + kBox, map, n0 + 64, k0, bar);\n  }\n")]
_CFB32_TAIL = "\n      },\n      [&](int slot) {\n        const float* s = sm + slot * 2 * kOp;\n"
CFB32_ACT = ("        fma_tiles<true>(a1, s, s + kOp);\n        fma_tiles<true>(dg, s + 2 * kOp, s + 3 * kOp);\n",
             "        (void)s;\n")
CFB32_DXA = ("stage_b<true>(s + kOp, w1_op, n0, k0);" + _CFB32_TAIL
             + "        fma_tiles<true>(acc, s, s + kOp);\n",
             "stage_b<true>(s + kOp, w1_op, n0, k0);" + _CFB32_TAIL + "        (void)s;\n")
CFB32_WGRAD = ("        fma_tiles<false>(acc, s, s + kOp);\n", "        (void)s;\n")
CFB_R, CFB_F = 24576, 2048  # the training default's rows: 4 x 768 points x 8 frames
CFF_ACT = ("    consume<0, 1>(ring, acc, 0, kSteps, wg);\n",
           "    for (int i = 0; i < kSteps; ++i) {\n      ring.wait(i);\n      ring.release(i);\n    }\n")
CFF_OUT = ("    consume<0, 1>(ring, acc, 0, i1 - i0, wg);\n",
           "    for (int i = 0; i < i1 - i0; ++i) {\n      ring.wait(i);\n      ring.release(i);\n    }\n")
CFF32_ACT = ("stage_b<false>(s + kOp, w1_op, f0, k0);" + _CFB32_TAIL
             + "        fma_tiles<true>(acc, s, s + kOp);\n",
             "stage_b<false>(s + kOp, w1_op, f0, k0);" + _CFB32_TAIL + "        (void)s;\n")
CFF32_OUT = ("stage_b<false>(s + kOp, w2_op, n0, k0);" + _CFB32_TAIL
             + "        fma_tiles<true>(acc, s, s + kOp);\n",
             "stage_b<false>(s + kOp, w2_op, n0, k0);" + _CFB32_TAIL + "        (void)s;\n")
CFF_GELU = ("        const float cdf = gelu_cdf(a);\n", "        const float cdf = 1.0f;\n")
# the forward's configurations beside the kernel's: its bf16 products one
# block an SM with six-stage rings; its f32 activation product two blocks an SM
CFF_ONE_BLOCK = [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;"),
                 ("constexpr int kActStages = 3;", "constexpr int kActStages = 6;"),
                 ("constexpr int kOutStages = 3;", "constexpr int kOutStages = 6;")]
CFF32_TWO_BLOCKS = [("__launch_bounds__(kThreads, 1)\nchanff_fwd_act_f32(",
                     "__launch_bounds__(kThreads, 2)\nchanff_fwd_act_f32(")]
# the forward's variants that change one dtype's kernels only
CFF_DTYPE = {"no copies": torch.bfloat16, "one block an SM": torch.bfloat16,
             "f32 act two blocks an SM": torch.float32}
CFF_SPLIT_R = (100, 1024, 2048)  # rows whose out product fwd_plan splits
# the chunked kernels: "no GELU" in both epilogues; the products; the copies
# (tma_box is the file's own TMA helper); the cluster's rank-order sums
CCH_GELU = [("      const uint32_t g = in ? pack2(v0 * phi(v0), v1 * phi(v1)) : 0u;",
             "      const uint32_t g = in ? pack2(v0, v1) : 0u;"),
            ("        const float cdf = phi(a);\n        g[e] = a * cdf;\n"
             "        d[e] = dg[4 * n + 2 * hi + e] * (cdf + a * gelu_pdf(a));\n",
             "        g[e] = a;\n        d[e] = dg[4 * n + 2 * hi + e];\n")]
CCH_ACT = [("        act_step(a1, xa_d, st, s, wg);\n", ""),
           ("        act_step(a1, dg, xa_d, st, s, wg);\n", "")]
CCH_OUT = [("        out_step(y0, y1, cur, st, t, wg);\n", ""),
           ("          dxa_step(d0, d1, cur, st, p / 2);\n", "")]
CCH_COPY = [("    bar_arrive_tx(full(s), bytes);\n", "    bar_arrive(full(s));\n"),
            ("int c1,\n" + " " * 40 + "uint32_t bar) {\n  asm volatile(",
             "int c1,\n" + " " * 40 + "uint32_t bar) {\n  if (c0 < -(1 << 30)) asm volatile(")]
CCH_SUM = [(f"      if (k >= split) break;\n#pragma unroll\n      for (int u = 0; u < {n}; ++u) {{",
            f"      if (k >= 1) break;\n#pragma unroll\n      for (int u = 0; u < {n}; ++u) {{")
           for n in ("kRound", "kU")]
CCH_CASES = ((1024, 512), (1024, 1024), (CFB_R, 512))  # (R, fc): the tool's rows, the train default
# the 3x3 conv's wgmma kernel (csrc/conv3x3_fwd.cu; its products are
# conv3x3_tiles.cuh's, CONV_MMA): the producer only arrives; the epilogue
# skips staging and stores (the accumulators kept live); and the tile
# configurations measured against the kernel's 4 x 30 tiles, three warpgroups
# and six slots: (output tile rows, consumer warpgroups, ring slots)
C3_COPY = [("        mbar_arrive_expect_tx(&full[s], kBoxBytes);\n"
            "        tma_load_4d(xs + s * kStageBytes, &x_map, 0, w0 - 1, h0 - 1, b, &full[s]);\n",
            "        mbar_arrive(&full[s]);\n")]
C3_EPI = [("    wgmma_wait<0>();\n",
           "    wgmma_wait<0>();\n"
           "    if (h0 < 0)\n"
           "      reinterpret_cast<float*>(junk)[ctid % 32] = acc[0] + acc[17] + acc[63];\n"
           "    prev = s;\n    continue;\n")]
C3_TILES = {"8 x 30 tiles, two warpgroups": (8, 2, 3), "6 x 30 tiles, three warpgroups": (6, 3, 4),
            "6 x 30 tiles, two warpgroups": (6, 2, 4), "4 x 30 tiles, two warpgroups": (4, 2, 6)}


def c3_config(th: int, wgs: int, stages: int) -> list:
    """The substitutions that build the wgmma conv with these constants."""
    subs = [("constexpr int TH = 4;                              // output tile rows",
             f"constexpr int TH = {th};"),
            ("constexpr int kWGs = 3;", f"constexpr int kWGs = {wgs};"),
            ("constexpr int kStages = 6;", f"constexpr int kStages = {stages};")]
    return [(old, new) for old, new in subs if not old.startswith(new)]


C3_SHAPES = (("window", 8, 240, 512), ("train default", 32, 184, 248), ("bench train", 8, 192, 256))
# the f32 conv (csrc/conv3x3_f32_tiles.cuh): the box's 16-byte copies, the
# weights' 4-byte transposing copies, the products' weight loads
C3F_BOX = ("          [&](int dst, size_t src, bool in, int) { cp_async_16z(xs + dst, x + src, in); });",
           "          [&](int dst, size_t src, bool in, int) {\n"
           "            if (c0 < 0) cp_async_16z(xs + dst, x + src, in);\n          });")
C3F_WCOPY = ("    cp_async_4z(ws + dst, w + (ok ? src : 0), ok);\n",
             "    if (c0 < 0) cp_async_4z(ws + dst, w + (ok ? src : 0), ok);\n")
C3F_WLOAD = ("        const float4 w0 = *reinterpret_cast<const float4*>(wq);\n"
             "        const float4 w1 = *reinterpret_cast<const float4*>(wq + 4);\n",
             "        const float4 w0 = make_float4(kk + kx, g, kk, kx), w1 = make_float4(g, kk, kx, 1);\n"
             "        (void)wq;\n")
C3F_SHAPES = (("window", 8, 240, 512), ("small", 2, 31, 70))
# the corr sampler (csrc/corr_sample_fwd.cu): no pixel loads (the patch reads
# as zeros); no products or dots (the loaded words are folded without
# multiplying); no reduction (the half-pixel sums and the reduce-scatter
# without their shuffles); no epilogue (the 49 outputs not combined, one
# score written); the tensor-core path's launch bounds at two and three
# blocks an SM against the kernel's four
CS_COPY = [("    return ok ? __ldg(reinterpret_cast<const uint4*>(base + off)) "
            ": make_uint4(0u, 0u, 0u, 0u);",
            "    return make_uint4(0u, 0u, 0u, ok ? 0u : (uint32_t)off);")]
CS_DOT = [("      mma_bf16(acc, a0, b0.x, b0.y);\n      mma_bf16(acc, a1, b0.z, b0.w);\n"
           "      mma_bf16(acc, a2, b1.x, b1.y);\n      mma_bf16(acc, a3, b1.z, b1.w);\n",
           "      acc[0] += __uint_as_float(a0[0] ^ a1[3] ^ a2[0] ^ a3[3] ^ b0.x ^ b1.w);\n"),
          ("        for (int e = 0; e < 8; ++e) d = fmaf(__uint_as_float(u[e]), tv[e], d);",
           "        for (int e = 0; e < 8; ++e) d += __uint_as_float(u[e]);\n        d += tv[r];")]
CS_RED = [("    const float d0 = acc[0] + __shfl_xor_sync(0xffffffffu, acc[1], 4);\n"
           "    const float d1 = acc[2] + __shfl_xor_sync(0xffffffffu, acc[3], 4);\n",
           "    const float d0 = acc[0] + acc[1];\n    const float d1 = acc[2] + acc[3];\n"),
          ("        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, half);",
           "        v[i] = keep + give;")]
CS_EPI = [("  combine(g, it, o, lane);", "  if (lane == 0) o[0] = g[it.px & 63];")]
CS_BLOCKS = {f"{w} blocks an SM": [("constexpr int kBlocksPerSM = 4;",
                                     f"constexpr int kBlocksPerSM = {n};")]
             for w, n in (("two", 2), ("three", 3))}
CS_LPW = (1, 2, 4)  # levels a warp: the kernel also at each
# (case, N, map dtype, target dtype) on a 60x128 level 0
CS_CASES = tuple((case, N, md, td) for case, N in (("flagship", 256), ("dense", 7680))
                 for md, td in (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                                ("float32", "float32")))
VARIANTS = {
    "stem_wgrad": {"kernel": [], "no x copies": [STEM_X], "no products": [STEM_MMA],
                   "dy only": [STEM_X, STEM_MMA], "no segments": [STEM_NONE],
                   "f32 no copies": STEM32_COPY, "f32 no shared loads": STEM32_LDS,
                   "f32 no products": [STEM32_FMA], "f32 no segments": [STEM32_NONE]},
    "mixer_probes": {"kernel": [], "no products": [SA_MMA], "no copies": SA_COPY},
    "conv3x3_stats": {"kernel": [], "no input copies": CONV_COPY, "no products": [CONV_MMA],
                      "no epilogue": [CONV_EPI]},
    "row_contract": {"kernel": [], "no copies": [RC_COPY], "no products": [RC_MMA],
                     "no cross-block sum": [RC_SUM]},
    "chanff_bwd": {"kernel": [], "no activation products": [CFB_ACT, CFB32_ACT],
                   "no dxa products": [CFB_DXA, CFB32_DXA],
                   "no weight-grad products": [CFB_WGRAD, CFB32_WGRAD], "no copies": CFB_COPY},
    "chanff_fwd": {"kernel": [], "no activation products": [CFF_ACT, CFF32_ACT],
                   "no out products": [CFF_OUT, CFF32_OUT], "no GELU": [CFF_GELU],
                   "no copies": CFB_COPY, "one block an SM": CFF_ONE_BLOCK,
                   "f32 act two blocks an SM": CFF32_TWO_BLOCKS},
    "chanff_chunk": {"kernel": [], "no GELU": CCH_GELU, "no activation products": CCH_ACT,
                     "no out/dxa products": CCH_OUT, "no copies": CCH_COPY,
                     "no cluster sum": CCH_SUM},
    "conv3x3_fwd": {"kernel": [], "no input copies": C3_COPY, "no products": [CONV_MMA],
                    "no epilogue": C3_EPI,
                    **{name: c3_config(*cfg) for name, cfg in C3_TILES.items()},
                    "f32 no copies": [C3F_BOX, C3F_WCOPY], "f32 no box copies": [C3F_BOX],
                    "f32 no weight copies": [C3F_WCOPY], "f32 no weight loads": [C3F_WLOAD]},
    "corr_sample_fwd": {"kernel": [], "no pixel loads": CS_COPY, "no products or dots": CS_DOT,
                        "no reduction": CS_RED, "no epilogue": CS_EPI, **CS_BLOCKS},
}


def _sources(stem: str) -> dict:
    """``csrc/<stem>.cu`` and the local headers it includes, at any depth:
    {file name: text}."""
    files, todo = {}, [f"{stem}.cu"]
    while todo:
        name = todo.pop()
        if name not in files:
            files[name] = (_build.CSRC / name).read_text()
            todo += re.findall(r'#include "([\w.]+)"', files[name])
    return files


def variant_sources(stem: str, subs) -> dict:
    """The files of ``stem``'s variant with ``subs`` made: each (old, new)
    replaces the one place ``old`` occurs in the source and its headers.
    Returns only the files that changed, {name: text}."""
    files, changed = _sources(stem), {}
    for old, new in subs:
        where = [n for n, text in files.items() if text.count(old)]
        if len(where) != 1 or files[where[0]].count(old) != 1:
            raise RuntimeError(f"{stem}.cu and its headers no longer hold {old!r} once: update "
                               "the variant")
        files[where[0]] = changed[where[0]] = files[where[0]].replace(old, new)
    return changed


def build(sources=None) -> dict:
    """Every variant's library (of ``sources``, default all), all nvcc
    processes at once, under ``build/pips_tpu_torch/variants/<source>_<i>/``
    (the changed files beside the library; a source's quoted includes find a
    changed header there first): {(source, variant): ctypes.CDLL}."""
    out = _build.BUILD_DIR / "variants"
    nvcc, running = _build._nvcc(), []
    for stem, variants in VARIANTS.items():
        if sources is not None and stem not in sources:
            continue
        for i, (name, subs) in enumerate(variants.items()):
            vdir = out / f"{stem}_{i}"
            vdir.mkdir(parents=True, exist_ok=True)
            files = {f"{stem}.cu": (_build.CSRC / f"{stem}.cu").read_text(),
                     **variant_sources(stem, subs)}
            for fname, text in files.items():
                (vdir / fname).write_text(text)
            cu, so = vdir / f"{stem}.cu", vdir / f"lib{stem}.so"
            proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                                     str(so), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            running.append((stem, name, so, proc))
    libs = {}
    for stem, name, so, proc in running:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {stem} variant {name!r}:\n"
                               + text.decode(errors="replace"))
        libs[(stem, name)] = ctypes.CDLL(str(so))
    return libs


def device_ms(call, rounds: int = ROUNDS, reps: int = REPS) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls queued
    behind a sleep kernel, per call."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return sorted(times)[len(times) // 2]


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stem_variants(libs: dict, B: int, H: int = 384, W: int = 512) -> dict:
    Ho, Wo = H // 2, W // 2
    rng = np.random.RandomState(B)
    x2, dy = (torch.from_numpy((rng.rand(*shape) - 0.5).astype(np.float32)).cuda().bfloat16()
              .permute(0, 3, 1, 2) for shape in ((B, 2 * Ho + 6, Wo + 3, 6), (B, Ho, Wo, 64)))
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in [n for n in VARIANTS["stem_wgrad"] if not n.startswith("f32 ")]:
        lib = stem_lib(libs, name)
        nb = lib.pips_stem_wgrad_blocks(B, Ho, Wo, x2.device.index)
        dk = torch.empty(64, 6, 7, 4, device="cuda")
        part = torch.empty(nb, dk.numel(), device="cuda")

        def call(lib=lib, nb=nb, dk=dk, part=part):
            checked(lib.pips_stem_wgrad(x2.data_ptr(), dy.data_ptr(), dk.data_ptr(),
                                        part.data_ptr(), nb, 128, B, x2.shape[2], x2.shape[3],
                                        Ho, Wo, 1, x2.device.index, stream), f"stem_wgrad {name}")

        out[name] = device_ms(call)
        if name == "kernel":
            err = (dk - stem_wgrad_reference(x2, dy)).abs().max().item()
            out["kernel max_abs_err"] = err
            out["blocks"] = nb
    return out


def stem_lib(libs: dict, name: str):
    lib = libs[("stem_wgrad", name)]
    lib.pips_stem_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.pips_stem_wgrad_blocks.argtypes = [ctypes.c_int] * 4
    return lib


def stem_f32_variants(libs: dict) -> dict:
    """The f32 kernel's variants at ``STEM32_CASES``, each launched as
    ``stem_wgrad_cuda.f32_plan`` lays it out; the kernel held to its plain
    version within 4 u K m (as smoke phase 3f) and timed beside
    ``torch.nn.grad.conv2d_weight`` in full f32 (TF32 off)."""
    from pips_tpu_torch.kernels.stem_wgrad_cuda import f32_plan

    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, B, H, W in STEM32_CASES:
        Ho, Wo = H // 2, W // 2
        rng = np.random.RandomState(B + H)
        x2, dy = (torch.from_numpy((rng.rand(*shape) - 0.5).astype(np.float32)).cuda()
                  .permute(0, 3, 1, 2) for shape in ((B, 2 * Ho + 6, Wo + 3, 6), (B, Ho, Wo, 64)))
        plan = f32_plan(B, Ho, Wo, sms)
        dk = torch.empty(64, 6, 7, 4, device="cuda")
        part = torch.empty(plan.blocks, dk.numel(), device="cuda")
        res = {"plan": plan._asdict()}
        for name in ["kernel"] + [n for n in VARIANTS["stem_wgrad"] if n.startswith("f32 ")]:
            lib = stem_lib(libs, name)

            def call(lib=lib, name=name):
                checked(lib.pips_stem_wgrad(x2.data_ptr(), dy.data_ptr(), dk.data_ptr(),
                                            part.data_ptr(), plan.blocks, plan.seg, B,
                                            x2.shape[2], x2.shape[3], Ho, Wo, 0, x2.device.index,
                                            stream), f"stem_wgrad f32 {name}")

            call()
            if name == "kernel":
                err = (dk - stem_wgrad_reference(x2, dy)).abs().max().item()
                tol = 4 * 2.0 ** -24 * B * Ho * Wo * 0.25
                if err > tol:
                    raise RuntimeError(f"stem_wgrad f32 {case}: max_abs_err {err} > {tol}")
                res["kernel max_abs_err"] = err
                res["conv2d_weight"] = device_ms(lambda: torch.nn.grad.conv2d_weight(
                    x2, (64, 6, 7, 4), dy, stride=(2, 1)))
            res[name] = device_ms(call)
        out[case] = res
    return out


def stream_variants(libs: dict) -> dict:
    x, w1 = debug_mixer_kernel.inputs("cuda")
    M, (NB, K, N) = x.shape[0], w1.shape
    o = torch.empty(M, N, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in VARIANTS["mixer_probes"]:
        fn = libs[("mixer_probes", name)].pips_probe_stream_accum
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def call(fn=fn):
            checked(fn(x.data_ptr(), w1.data_ptr(), o.data_ptr(), M, N, NB, x.stride(0),
                       x.device.index, stream), f"stream_accum {name}")

        out[name] = device_ms(call)
        if name == "kernel":
            out["kernel max_abs_err"] = (o - stream_accum_reference(x, w1)).abs().max().item()
    return out


def conv_variants(libs: dict, B: int = 8, H: int = 192, W: int = 256) -> dict:
    rng = np.random.RandomState(B + H)
    x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).cuda().bfloat16()
    x = x.permute(0, 3, 1, 2)
    w = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.06).astype(np.float32)).cuda()
    b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32)).cuda()
    aff = torch.from_numpy(np.stack([0.5 + rng.rand(B, 64), 0.3 * rng.randn(B, 64)],
                                    axis=1).astype(np.float32)).cuda()
    wk = w.bfloat16().contiguous()
    plan = block_cuda.pass_plan(B, H, W, torch.bfloat16,
                                sms=torch.cuda.get_device_properties(0).multi_processor_count)
    T = plan.T
    y = torch.empty_like(x)
    part = torch.empty(B, 2, 64, T, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in VARIANTS["conv3x3_stats"]:
        fn = libs[("conv3x3_stats", name)].pips_conv3x3_stats
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        for prologue in ((1, 0) if name == "kernel" else (1,)):
            def call(fn=fn, prologue=prologue):
                checked(fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), aff.data_ptr(),
                           y.data_ptr(), part.data_ptr(), B, H, W, T, prologue, 1,
                           plan.tile_outputs, plan.grid, x.device.index, stream),
                        f"conv_pass {name}")

            out[name if prologue else "kernel, prologue off"] = device_ms(call)
            if name == "kernel" and prologue:
                y_ref, st_ref = block_cuda.conv_pass_reference(x, w, b, aff, True)
                out["kernel max_abs_err"] = (y.float() - y_ref.float()).abs().max().item()
                out["kernel stats max_rel_err"] = ((part.sum(-1) - st_ref).abs()
                                                   / st_ref.abs().clamp_min(1e-30)).max().item()
    return out


def contract_variants(libs: dict) -> dict:
    a0, b0 = probe_mosaic_ops.inputs("cuda")
    TH, Wo, C, O, T = (probe_mosaic_ops.TH, probe_mosaic_ops.Wo, probe_mosaic_ops.C,
                       probe_mosaic_ops.O, probe_mosaic_ops.TILES)
    shapes = {"A": (a0.reshape(1, TH * Wo, C), b0.reshape(1, TH * Wo, O)),
              "C": (a0[:, :T].transpose(0, 1), b0[:, 0][None].expand(T, TH, O))}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for probe, (a, b) in shapes.items():
        G, R, CA = a.shape
        CB = b.shape[2]
        strides = (a.stride(0), a.stride(1)), (b.stride(0), b.stride(1))
        o = torch.empty(G, CA, CB, device="cuda")
        plans = {name: row_contract_cuda.launch_plan(G, R, CA, CB, *strides)
                 for name in VARIANTS["row_contract"]}
        plans["general path"] = row_contract_cuda.launch_plan(G, R, CA, CB, *strides, a_align=2)
        res = {}
        for name, plan in plans.items():
            fn = libs[("row_contract", "kernel" if name == "general path" else name)]
            fn = fn.pips_row_contract
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            part = (None if plan.scratch is None
                    else torch.empty(plan.scratch, device="cuda"))

            def call(fn=fn, plan=plan, part=part):
                checked(fn(a.data_ptr(), b.data_ptr(), o.data_ptr(),
                           None if part is None else part.data_ptr(), G, R, CA, CB,
                           *strides[0], *strides[1], int(plan.fast), plan.splits,
                           plan.rows_per_block, a.device.index, stream),
                        f"row_contract {probe} {name}")

            res[name] = device_ms(call)
            if name in ("kernel", "general path"):
                res[f"{name} max_abs_err"] = (
                    o - row_contract_cuda.row_contract_reference(a, b)).abs().max().item()
        res["plan"] = dataclasses.asdict(plans["kernel"])
        out[probe] = res
    return out


def chanff_bwd_variants(libs: dict, dtype: torch.dtype, R: int = CFB_R, F: int = CFB_F) -> dict:
    """One ``pips_chanff_bwd`` call of each variant at (R, 512) x F in
    ``dtype``; for the kernel, the largest error of each grad against the
    plain version and each launch's device time under the profiler."""
    rng = np.random.RandomState(R)
    vals = [rng.randn(R, 512), rng.randn(R, 512), 1.0 + 0.1 * rng.randn(512),
            0.1 * rng.randn(512), rng.randn(512, F) / np.sqrt(512), 0.1 * rng.randn(F),
            rng.randn(F, 512) / np.sqrt(F)]
    dts = [dtype, dtype, torch.float32, torch.float32, dtype, torch.float32, dtype]
    args = [torch.from_numpy(v.astype(np.float32)).to("cuda", dt) for v, dt in zip(vals, dts)]
    x = args[0]
    plan = mixer_cuda.bwd_plan(R, F, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    outs, scratch = mixer_cuda.bwd_buffers(x, plan)
    ptrs = [t.data_ptr() for t in args + list(outs)] + [None if t is None else t.data_ptr()
                                                        for t in scratch.values()]
    stream = torch.cuda.current_stream().cuda_stream
    out = {"split": plan.split}
    for name in VARIANTS["chanff_bwd"]:
        if name == "no copies" and dtype == torch.float32:
            continue  # the f32 kernels copy by cp.async, which this variant leaves
        fn = libs[("chanff_bwd", name)].pips_chanff_bwd
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

        def call(fn=fn):
            checked(fn(*ptrs, R, 512, F, plan.tile_rows, plan.split,
                       int(dtype == torch.bfloat16), 0, stream), f"chanff_bwd {name}")

        out[name] = device_ms(call, reps=5)
        if name == "kernel":
            call()
            ref = mixer_cuda.chan_ff_bwd_reference(*args)
            out["kernel max_abs_err"] = [(o.float() - r.float()).abs().max().item()
                                         for o, r in zip(outs, ref)]
            out["kernel ms by launch"] = launch_ms(call, plan.launches, r"chanff_bwd_\w+")
    return out


def fwd_inputs(R: int, F: int, dtype: torch.dtype) -> tuple:
    """The block's inputs at (R, 512) x F in ``dtype``, its output buffer,
    the plan's scratch and the C entry's pointers to them: (args, y,
    scratch, pointers). The caller holds the scratch while it calls."""
    rng = np.random.RandomState(R + 1)
    vals = [rng.randn(R, 512), 1.0 + 0.1 * rng.randn(512), 0.1 * rng.randn(512),
            rng.randn(512, F) / np.sqrt(512), 0.1 * rng.randn(F), rng.randn(F, 512) / np.sqrt(F),
            0.1 * rng.randn(512)]
    dts = [dtype, torch.float32, torch.float32, dtype, torch.float32, dtype, torch.float32]
    args = [torch.from_numpy(v.astype(np.float32)).to("cuda", dt) for v, dt in zip(vals, dts)]
    plan = mixer_cuda.fwd_plan(R, F, dtype)
    y = torch.empty_like(args[0])
    scratch = [torch.empty(shape, dtype=dt, device="cuda") for shape, dt in plan.scratch.values()]
    return args, y, scratch, [t.data_ptr() for t in args + [y] + scratch]


def fwd_caller(lib, ptrs, R: int, F: int, dtype: torch.dtype, split: int, what: str):
    """A call of ``lib``'s ``pips_chanff_fwd`` on ``ptrs`` at ``split``."""
    fn = lib.pips_chanff_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        checked(fn(*ptrs, R, 512, F, mixer_cuda.TILE_ROWS, split, int(dtype == torch.bfloat16),
                   0, stream), what)

    return call


def chanff_fwd_variants(libs: dict, dtype: torch.dtype, R: int = CFB_R, F: int = CFB_F) -> dict:
    """One ``pips_chanff_fwd`` call of each variant at (R, 512) x F in
    ``dtype``; for the kernel, its largest error against the plain version
    and each launch's device time under the profiler."""
    args, y, scratch, ptrs = fwd_inputs(R, F, dtype)  # scratch held while the calls run
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = mixer_cuda.fwd_plan(R, F, dtype, sms)
    out = {"split": plan.split}
    for name in VARIANTS["chanff_fwd"]:
        if CFF_DTYPE.get(name, dtype) != dtype:
            continue  # a variant of the other dtype's kernels (f32 copies by cp.async)
        call = fwd_caller(libs[("chanff_fwd", name)], ptrs, R, F, dtype, plan.split,
                          f"chanff_fwd {name}")
        out[name] = device_ms(call, reps=10)
        if name == "kernel":
            call()
            ref = mixer_cuda.chan_ff_reference(*args)
            out["kernel max_abs_err"] = (y.float() - ref.float()).abs().max().item()
            out["kernel ms by launch"] = launch_ms(call, plan.launches, r"chanff_fwd_\w+")
    return out


def chanff_fwd_splits(libs: dict, F: int = CFB_F) -> dict:
    """The forward at each split its C entry takes (1, 2, 4) where
    ``fwd_plan`` splits (``CFF_SPLIT_R``), both dtypes, beside the plan's
    choice: what that choice rests on. Every split is held to the plain
    version (bf16 within two ulps of the output's magnitude, f32 1e-4)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for R in CFF_SPLIT_R:
            args, y, scratch, ptrs = fwd_inputs(R, F, dtype)  # scratch held, as above
            ref = mixer_cuda.chan_ff_reference(*args).float()
            tol = (2.0 ** (np.ceil(np.log2(ref.abs().max().item())) - 7)
                   if dtype == torch.bfloat16 else 1e-4)
            res = {"plan": mixer_cuda.fwd_plan(R, F, dtype, sms).split}
            for split in (1, 2, 4):
                call = fwd_caller(libs[("chanff_fwd", "kernel")], ptrs, R, F, dtype, split,
                                  f"chanff_fwd split {split}")
                call()
                err = (y.float() - ref).abs().max().item()
                if err > tol:
                    raise RuntimeError(f"chanff_fwd {dtype} R={R} split {split}: max_abs_err "
                                       f"{err} > {tol}")
                res[split] = device_ms(call)
            out[f"{str(dtype).split('.')[-1]} R={R}"] = res
    return out


def chunk_variants(libs: dict, R: int, fc: int, F: int = CFB_F) -> dict:
    """The chunked forward kernel and the backward's row kernel of each
    variant at (R, 512) x F, chunks of fc, split as ``chunk_plan`` does; for
    the kernel, the forward's largest error against its plain version, and
    the kernel at every split its C entry takes there (each forward held to
    two bf16 ulps of the output's magnitude)."""
    bf16 = torch.bfloat16
    rng = np.random.RandomState(R + fc)
    x, dy = (torch.from_numpy(rng.randn(R, 512).astype(np.float32)).cuda().to(bf16)
             for _ in range(2))
    scale, bias = (torch.from_numpy(v.astype(np.float32)).cuda()
                   for v in (1.0 + 0.1 * rng.randn(512), 0.1 * rng.randn(512)))
    w1 = torch.from_numpy((rng.randn(512, F) / np.sqrt(512)).astype(np.float32)).cuda().to(bf16)
    b1 = torch.from_numpy((0.1 * rng.randn(F)).astype(np.float32)).cuda()
    w2 = torch.from_numpy((rng.randn(F, 512) / np.sqrt(F)).astype(np.float32)).cuda().to(bf16)
    b2 = torch.from_numpy((0.1 * rng.randn(512)).astype(np.float32)).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = chanff_chunk_cuda.chunk_plan(R, F, fc, sms)
    y, dx = torch.empty_like(x), torch.empty_like(x)
    _, scratch = chanff_chunk_cuda.bwd_buffers(x, plan)
    fargs = [t.data_ptr() for t in (x, scale, bias, w1, b1, w2, b2, y)]
    bargs = [t.data_ptr() for t in (x, dy, scale, bias, w1, b1, w2, dx)] + [
        scratch[k].data_ptr() for k in ("xa", "g1", "da1", "part_d", "part_f")]
    stream = torch.cuda.current_stream().cuda_stream

    def callers(lib, split, name):
        fwd, bwd = lib.pips_chanff_chunk_fwd, lib.pips_chanff_chunk_bwd_rows
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        ints = (R, 512, F, fc, chanff_chunk_cuda.ROW_TILE, split, 0)
        return (lambda: checked(fwd(*fargs, *ints, stream), f"chanff_chunk_fwd {name}"),
                lambda: checked(bwd(*bargs, *ints, stream), f"chanff_chunk_bwd_rows {name}"))

    ref = chanff_chunk_cuda.chan_ff_chunked_reference(x, scale, bias, w1, b1, w2, b2, fc=fc).float()
    tol = 2.0 ** (np.ceil(np.log2(ref.abs().max().item())) - 7)
    reps = 20 if R < 4096 else 5
    out = {"split": plan.fwd.split}
    for name in VARIANTS["chanff_chunk"]:
        fwd, bwd = callers(libs[("chanff_chunk", name)], plan.fwd.split, name)
        out[name] = {"fwd": device_ms(fwd, reps=reps), "bwd rows": device_ms(bwd, reps=reps)}
        if name == "kernel":
            fwd()
            out["kernel max_abs_err"] = (y.float() - ref).abs().max().item()
    splits = {}
    for split in (1, 2, 4, 8):
        if F % (split * fc):
            continue
        fwd, bwd = callers(libs[("chanff_chunk", "kernel")], split, f"split {split}")
        fwd()
        err = (y.float() - ref).abs().max().item()
        if err > tol:
            raise RuntimeError(f"chanff_chunk_fwd R={R} fc={fc} split {split}: max_abs_err {err} "
                               f"> {tol}")
        splits[split] = {"fwd": device_ms(fwd, reps=reps), "bwd rows": device_ms(bwd, reps=reps)}
    out["splits"] = splits
    return out


def conv3_variants(libs: dict) -> dict:
    """Each variant of the wgmma conv at the three bf16 stage-1 shapes, and
    for the kernel its largest error against the plain version and
    ``F.conv2d``'s time in turns with it (each configuration's output held to
    two bf16 ulps as well)."""
    from pips_tpu_torch.kernels import conv_cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, B, H, W in C3_SHAPES:
        rng = np.random.RandomState(B + H)
        x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).cuda().bfloat16()
        x = x.permute(0, 3, 1, 2)
        w = torch.from_numpy((rng.randn(64, 64, 3, 3) / 24).astype(np.float32)).cuda()
        b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32)).cuda()
        wk = w.bfloat16().contiguous()
        y = torch.empty_like(x)
        ref = conv_cuda.conv3x3_reference(x, w, b).float()
        tol = 2.0 ** (np.ceil(np.log2(ref.abs().max().item())) - 7)
        res = {}
        for name in [n for n in VARIANTS["conv3x3_fwd"] if not n.startswith("f32 ")]:
            fn = libs[("conv3x3_fwd", name)].pips_conv3x3_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            th = C3_TILES[name][0] if name in C3_TILES else conv_cuda.PATHS["conv3x3_wgmma"].tile[0]
            grid = min(B * -(-H // th) * -(-W // 30), sms)

            def call(fn=fn, th=th, grid=grid, name=name):
                checked(fn(x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), B, 64, H, W,
                           64, 1, 2, th, 64, grid, x.device.index, stream),
                        f"conv3x3_fwd {name}")

            call()
            err = (y.float() - ref).abs().max().item()
            if (name == "kernel" or name in C3_TILES) and err > tol:
                raise RuntimeError(f"conv3x3_fwd {name} {case}: max_abs_err {err} > {tol}")
            res[name] = device_ms(call)
            if name == "kernel":
                res["kernel max_abs_err"] = err
                res["F.conv2d"] = device_ms(lambda: torch.nn.functional.conv2d(
                    x, wk, b.bfloat16(), padding=1))
                res["kernel again"] = device_ms(call)
        out[case] = res
    return out


def conv3_f32_variants(libs: dict) -> dict:
    """The f32 conv's variants at ``C3F_SHAPES``, each launched as
    ``conv_cuda.launch_plan`` lays it out; the kernel held to its plain
    version (TF32 off) and timed beside ``F.conv2d``."""
    from pips_tpu_torch.kernels import conv_cuda

    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, B, H, W in C3F_SHAPES:
        rng = np.random.RandomState(B + H)
        x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).cuda().permute(0, 3, 1, 2)
        w = torch.from_numpy((rng.randn(64, 64, 3, 3) / 24).astype(np.float32)).cuda()
        b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32)).cuda()
        y = torch.empty_like(x)
        plan = conv_cuda.launch_plan(B, 64, 64, H, W, torch.float32, sms=sms)
        res = {}
        for name in ["kernel"] + [n for n in VARIANTS["conv3x3_fwd"] if n.startswith("f32 ")]:
            fn = libs[("conv3x3_fwd", name)].pips_conv3x3_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

            def call(fn=fn, name=name):
                checked(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, 64, H, W, 64,
                           0, plan.path.code, plan.path.tile[0], plan.tile_outputs, plan.grid,
                           x.device.index, stream), f"conv3x3_f32 {name}")

            call()
            if name == "kernel":
                err = (y - conv_cuda.conv3x3_reference(x, w, b)).abs().max().item()
                if err > 1e-4:
                    raise RuntimeError(f"conv3x3_f32 {case}: max_abs_err {err} > 1e-4")
                res["kernel max_abs_err"] = err
                res["F.conv2d"] = device_ms(lambda: torch.nn.functional.conv2d(x, w, b, padding=1))
            res[name] = device_ms(call)
        out[case] = res
    return out


def corr_variants(libs: dict) -> dict:
    """Each variant of the corr sampler at the smoke's flagship (N=256) and
    dense (N=7680) inputs on a 60x128 level 0, with each (map, target) dtype
    pair; for the kernel, its largest error against the plain version and
    its time at one, two and four levels a warp."""
    from pips_tpu_torch.kernels import corr_cuda
    from pips_tpu_torch.ops.corr import build_fmap_pyramid

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for case, N, md, tgt in CS_CASES:
        rng = np.random.RandomState(N)
        fm = torch.from_numpy(rng.randn(1, 8, 60, 128, 128).astype(np.float32)).cuda()
        fm = fm.to(getattr(torch, md))
        pyramid = [p.contiguous() for p in build_fmap_pyramid(fm, 4)]
        targets = torch.from_numpy(rng.randn(1, 8, N, 128).astype(np.float32)).cuda()
        targets = targets.to(getattr(torch, tgt))
        coords = torch.from_numpy(np.stack([rng.uniform(-4, 131, (1, 8, N)),
                                            rng.uniform(-4, 63, (1, 8, N))], -1)
                                  .astype(np.float32)).cuda()
        o = torch.empty(1, 8, N, 4 * 49, device="cuda")
        L = 4
        maps = (ctypes.c_void_p * L)(*(p.data_ptr() for p in pyramid))
        hs = (ctypes.c_int * L)(*(p.shape[2] for p in pyramid))
        ws = (ctypes.c_int * L)(*(p.shape[3] for p in pyramid))
        tst = (ctypes.c_longlong * 3)(*targets.stride()[:3])
        cst = (ctypes.c_longlong * 3)(*coords.stride()[:3])
        ref = corr_cuda.corr_sample_reference(pyramid, targets, coords)
        plan = corr_cuda.launch_plan(1, 8, N, L, fm.dtype, targets.dtype,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
        res = {}
        for name in VARIANTS["corr_sample_fwd"]:
            fn = libs[("corr_sample_fwd", name)].pips_corr_sample_fwd
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def call(fn=fn, name=name, p=plan):
                checked(fn(maps, hs, ws, L, targets.data_ptr(), tst, coords.data_ptr(), cst,
                           o.data_ptr(), 1, 8, N, 128, int(md == "bfloat16"),
                           int(tgt == "bfloat16"), p.path, p.lpw,
                           p.grid, 128 ** -0.5, 0, stream), f"corr_sample {name}")

            res[name] = device_ms(call)
            if name == "kernel":
                call()
                res["kernel max_abs_err"] = (o - ref).abs().max().item()
                res["levels a warp"] = plan.lpw
                for k in CS_LPW:
                    p = corr_cuda.launch_plan(1, 8, N, L, fm.dtype, targets.dtype, lpw=k)
                    call(p=p)
                    res[f"{k} levels a warp"] = {"ms": device_ms(lambda p=p: call(p=p)),
                                                 "max_abs_err": (o - ref).abs().max().item()}
        out[f"{case} N={N} {md}/{tgt}"] = res
    return out


def launch_ms(call, launches: int, pattern: str) -> dict:
    """Each launch's device time (ms) of one call, by kernel name, averaged
    over three calls under the profiler. The trace may miss the first
    kernels of a session: one call warms it, and the last three calls'
    kernels are the last in the trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            call()
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                    for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {}
    for _, name, us in events[-3 * launches:]:
        k = re.search(pattern, name).group(0)
        out[k] = out.get(k, 0.0) + us / 3e3
    return out


def main(sources=None) -> dict:
    """Times the variants of ``sources`` (source stems; default all) and
    prints them as one JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profile_pipelines times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    unknown = set(sources or ()) - set(VARIANTS)
    if unknown:
        raise ValueError(f"no variants of {sorted(unknown)}; sources: {sorted(VARIANTS)}")
    libs = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    res = {"device": torch.cuda.get_device_name(0), "nvidia-smi": smi[0] if smi else None}
    runs = {"stem_wgrad": lambda: {"stem_wgrad B=8": stem_variants(libs, 8),
                                   "stem_wgrad B=1": stem_variants(libs, 1),
                                   "stem_wgrad f32": stem_f32_variants(libs)},
            "mixer_probes": lambda: {"stream_accum": stream_variants(libs)},
            "conv3x3_stats": lambda: {"conv_pass": conv_variants(libs)},
            "row_contract": lambda: {"row_contract": contract_variants(libs)},
            "chanff_bwd": lambda: {"chanff_bwd bf16": chanff_bwd_variants(libs, torch.bfloat16),
                                   "chanff_bwd f32": chanff_bwd_variants(libs, torch.float32)},
            "chanff_fwd": lambda: {"chanff_fwd bf16": chanff_fwd_variants(libs, torch.bfloat16),
                                   "chanff_fwd f32": chanff_fwd_variants(libs, torch.float32),
                                   "chanff_fwd splits": chanff_fwd_splits(libs)},
            "chanff_chunk": lambda: {f"chanff_chunk R={R} fc={fc}": chunk_variants(libs, R, fc)
                                     for R, fc in CCH_CASES},
            "conv3x3_fwd": lambda: {"conv3x3_same": conv3_variants(libs),
                                    "conv3x3_f32": conv3_f32_variants(libs)},
            "corr_sample_fwd": lambda: {"corr_sample": corr_variants(libs)}}
    for stem in VARIANTS:
        if sources is None or stem in sources:
            res.update(runs[stem]())
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:] or None)
