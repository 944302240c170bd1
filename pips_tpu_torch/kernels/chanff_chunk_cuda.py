"""F-chunked MLP-Mixer channel block ``y = x + fc2(gelu(fc1(LN(x))))`` for Hopper.

Counterpart of ``tools/profile_chanff_chunk.py``'s ``make_chunked(fc)``: the
channel block with F walked in static chunks of ``fc`` columns, forward and
backward, with the JAX custom VJP's contract (``chan_ff_block_chunked``). On
a bf16 CUDA tensor the forward launches ``csrc/chanff_chunk.cu:chanff_chunk_fwd``
(which replaces the TPU kernel of ``make_chunked``'s fwd, :121) and the
backward ``chanff_chunk_bwd_rows`` (its bwd, :149), finished by
``csrc/chanff_bwd.cu``'s weight-grad products and ordered column sums
(``mixer_cuda.bwd_finish``, told that the partials come in tiles of
``ROW_TILE`` rows), as ``chunk_plan`` lays them out: one fused chunk pipeline
a call, each block a 64-row tile and a run of whole chunks of F, the blocks
of a row tile a cluster that adds its partial sums in rank order.

``chan_ff_chunked_reference`` and ``chan_ff_chunked_bwd_reference`` are the
plain versions, transcriptions of ``_fwd_kernel_chunked`` and
``_bwd_kernel_chunked``: the fc1 and fc2 products stay in f32 with the f32
bias, o and dxa accumulate chunk by chunk in f32, and y is rounded once. That
is not ``mixer_cuda.chan_ff_reference``, which rounds the products to x's
dtype before the bias, as the flax model does.

A CPU tensor goes to the plain versions, in f32 or bf16. A CUDA tensor
launches the kernels or raises. In bf16 those are ``chanff_chunk.cu``'s, at
the widths in ``FCS``. In f32 they are ``mixer_cuda``'s f32 kernels, the
register-tiled SGEMMs of ``csrc/chanff_fwd.cu`` and ``chanff_bwd.cu``,
at any fc that divides F: with ``cdtype = f32`` every cast to the compute
dtype in ``_fwd_kernel_chunked`` and ``_bwd_kernel_chunked`` is the
identity, so chunking F rounds nothing, and the f32 chunked block is the f32
monolithic block with its sums taken in another order. Those calls count,
one a call whatever kernels its plan launches, in ``mixer_cuda.launches``
and ``mixer_cuda.bwd_f32_launches``, not here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pips_tpu_torch.kernels import _build, mixer_cuda

FCS = (128, 256, 512, 1024)  # chunk widths the kernels take
KERNEL_D = 512  # the channel width the kernels are built for (csrc/chanff_chunk.cu's kD)
# the launch plan (csrc/chanff_chunk.cu holds the same constants)
ROW_TILE = 64          # rows of a block: one wgmma M, the backward's partial tiles
MAX_SPLIT = 8          # blocks of a row tile's cluster at most
FWD_SLAB, BWD_SLAB = 256, 128  # F columns a slab of each kernel's pipeline
ALIGN = 1024           # the dynamic shared memory's alignment slack
TILE_BYTES = ROW_TILE * KERNEL_D * 2  # the resident xa tile
FWD_STAGES, FWD_SLOT = 3, 32768
BWD_STAGES, BWD_SLOT = 3, 40960
SMEM_LIMIT = 232448    # a block's shared memory on an H100
# shared memory a block of each kernel takes: xa, two slabs (g1 64 x 256,
# da1 64 x 128), the ring's slots and mbarriers, a slab's b1; the backward's
# row statistics (64 float2) and column partials (4 KB)
FWD_SMEM = (ALIGN + TILE_BYTES + 2 * ROW_TILE * FWD_SLAB * 2 + FWD_STAGES * (FWD_SLOT + 16)
            + FWD_SLAB * 4)
BWD_SMEM = (ALIGN + TILE_BYTES + 2 * ROW_TILE * BWD_SLAB * 2 + BWD_STAGES * (BWD_SLOT + 16)
            + ROW_TILE * 8 + 4096 + BWD_SLAB * 4)
# an H100's (132 SMs) clusters of each size that fit at once at one block an
# SM (cudaOccupancyMaxActiveClusters; its GPCs leave SMs over); smoke 3h
# checks the plan against the card's own count
CLUSTERS_AT_ONCE = {1: 132, 2: 66, 4: 30, 8: 15}
_SQRT2 = math.sqrt(2.0)

launches = 0      # forward kernel launches so far; read (and reset) by chip_smoke.py
bwd_launches = 0  # backward calls so far (the row kernel and the finishing launches)
_fns: dict[str, object] = {}
# C entry of csrc/chanff_chunk.cu -> (pointer arguments, int arguments); the
# kernels' entries then take a stream pointer
_ENTRIES = {"pips_chanff_chunk_fwd": (8, 7), "pips_chanff_chunk_bwd_rows": (13, 7),
            "pips_chanff_chunk_max_clusters": (0, 3)}


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """One pass (the forward, or the backward) of a chunked call: the grid of
    its chunked kernel (``split`` blocks of a row tile along x, one cluster,
    row tiles along y), its cluster shape, the F columns [f0, f1) of each of
    a cluster's blocks in rank order, the rows of a row tile (the
    backward's partial tiles), the kernels one call enqueues in launch order,
    the scratch the wrapper allocates (name -> (shape, dtype), in the C
    entries' order, None where there is none) and a block's shared memory."""
    grid: tuple
    cluster: tuple
    runs: tuple
    row_tile: int
    kernels: tuple
    scratch: dict
    smem: int

    @property
    def split(self) -> int:
        return self.cluster[0]


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """The forward's and the backward's launches for x (R, 512) in bf16, F
    hidden columns in chunks of ``fc``; ``finish`` is ``mixer_cuda``'s plan
    whose weight-grad products and column sums end the backward."""
    R: int
    F: int
    fc: int
    fwd: PassPlan
    bwd: PassPlan
    finish: mixer_cuda.BwdPlan


def clusters_at_once(split: int, sms: int = mixer_cuda.SMS) -> int:
    """Clusters of ``split`` blocks a card of ``sms`` SMs holds at once, one
    block an SM (``CLUSTERS_AT_ONCE``, scaled to the card's SMs)."""
    return CLUSTERS_AT_ONCE[split] * sms // mixer_cuda.SMS


def _split(row_tiles: int, chunks: int, sms: int) -> int:
    """The most blocks a row tile gets: a power of two that cuts the chunks
    into equal runs, where all the blocks fit the card at once and all the
    clusters too (a second wave of clusters costs what a whole call does)."""
    for s in (8, 4, 2):
        if s <= MAX_SPLIT and chunks % s == 0 and row_tiles * s <= sms \
                and row_tiles <= clusters_at_once(s, sms):
            return s
    return 1


def _pass(R: int, F: int, split: int, kernels: tuple, scratch: dict, smem: int) -> PassPlan:
    run = F // split
    return PassPlan(grid=(split, -(-R // ROW_TILE), 1), cluster=(split, 1, 1),
                    runs=tuple((r * run, (r + 1) * run) for r in range(split)),
                    row_tile=ROW_TILE, kernels=kernels, scratch=scratch, smem=smem)


@functools.lru_cache(maxsize=64)  # one plan a shape: the wrapper asks on every call
def chunk_plan(R: int, F: int, fc: int, sms: int = mixer_cuda.SMS) -> ChunkPlan:
    """The launches of one chunked call at x (R, 512) bf16, F hidden columns
    in chunks of ``fc``, on a card of ``sms`` SMs. Each pass is one kernel
    over 64-row tiles whose F is cut into runs of whole chunks, in chunk
    order, one block a run; the backward's row kernel is followed by
    ``chanff_bwd.cu``'s weight-grad products and ordered column sums. The
    forward allocates no scratch: g1 stays on chip."""
    if R <= 0 or F <= 0 or fc not in FCS or F % fc:
        raise ValueError(f"no chunked plan for R={R}, F={F}, fc={fc}")
    row_tiles, chunks = -(-R // ROW_TILE), F // fc
    split = _split(row_tiles, chunks, sms)
    bf16, f32, D = torch.bfloat16, torch.float32, KERNEL_D
    finish = mixer_cuda.bwd_plan(R, F, bf16, sms)
    fwd = _pass(R, F, split, ("chanff_chunk_fwd",), {}, FWD_SMEM)
    scratch = {"xa": ((R, D), bf16), "g1": ((R, F), bf16), "da1": ((R, F), bf16),
               "part_d": ((row_tiles, 3, D), f32), "part_f": ((row_tiles, F), f32),
               "wsplit": finish.scratch["wsplit"]}
    bwd = _pass(R, F, split, ("chanff_chunk_bwd_rows", "chanff_bwd_wgrad", "chanff_bwd_colsum"),
                scratch, BWD_SMEM)
    return ChunkPlan(R, F, fc, fwd, bwd, finish)


def chan_ff_chunked_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, *, fc: int):
    """Plain PyTorch ``_fwd_kernel_chunked``: x (R, D) in the compute dtype,
    w1 (D, F) and w2 (F, D) cast to it, f32 vectors; returns (R, D) in x's
    dtype. LN statistics in f32 (var = E[x^2] - mu^2 clamped at 0); per chunk
    of ``fc`` columns, a1 = xa_c @ w1 chunk (f32 sums of the compute-dtype
    products) + b1, exact-erf GELU, and o += gelu_c @ w2 chunk in f32; then
    y = x + o + b2, rounded once."""
    cd = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    xa_c = (xn * ln_scale.float() + ln_bias.float()).to(cd)
    w1, w2 = w1.to(cd), w2.to(cd)
    o = torch.zeros_like(xf)
    for f in range(0, w1.shape[1], fc):
        a1 = mixer_cuda._mm(xa_c, w1[:, f:f + fc]) + b1[f:f + fc].float()
        g1 = 0.5 * a1 * (1.0 + torch.erf(a1 / _SQRT2))
        o = o + mixer_cuda._mm(g1.to(cd), w2[f:f + fc])
    return (xf + o + b2.float()).to(cd)


def chan_ff_chunked_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, *, fc: int):
    """Plain PyTorch ``_bwd_kernel_chunked``: ``chan_ff_bwd_reference``'s
    contract and math with dxa summed chunk by chunk in f32 (every other grad
    is a sum over rows, the same whether F is chunked or not)."""
    return mixer_cuda.chan_ff_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=fc)


def _check_fc(x, w1, fc) -> None:
    F = w1.shape[-1]
    if not isinstance(fc, int) or fc <= 0 or F % fc:
        raise ValueError(f"fc must be a positive divisor of F={F}, got {fc!r}")
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and fc not in FCS:
        raise ValueError(f"the CUDA bf16 chunked channel block takes fc in {FCS}, got {fc}")
    if x.device.type == "cuda" and x.shape[-1] != KERNEL_D:
        raise ValueError(f"the CUDA chunked channel block takes D={KERNEL_D}, got {x.shape[-1]}")


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/chanff_chunk.cu`` (built at first use), typed."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("chanff_chunk"), name)
        n_ptr, n_int = _ENTRIES[name]
        stream = [ctypes.c_void_p] if n_ptr else []
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + stream
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def max_clusters(backward: bool, split: int, device: int = 0) -> int:
    """Clusters of ``split`` blocks of the forward kernel (or the backward's
    row kernel) that the card holds at once, as the driver counts them."""
    n = _kernel("pips_chanff_chunk_max_clusters")(int(backward), split, device)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {-n}")
    return n


def _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, fc: int):
    """The block's value: the plain version on a CPU tensor, the kernel on
    CUDA. w1, w2 are in x's dtype here."""
    global launches
    if x.device.type == "cpu":
        return chan_ff_chunked_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, fc=fc)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_block_chunked runs on cpu or cuda, not {x.device}")
    if x.dtype == torch.float32:  # chunking F rounds nothing in f32: the monolithic kernel
        return mixer_cuda._forward(x, ln_scale, ln_bias, w1, b1, w2, b2)
    R, D = x.shape
    F = w1.shape[1]
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    mixer_cuda._cuda_ready("chan_ff_block_chunked", args, R, D, F)
    dev = x.device
    plan = chunk_plan(R, F, fc, mixer_cuda._device_sms(dev)).fwd
    y = torch.empty_like(x)
    err = _kernel("pips_chanff_chunk_fwd")(*(t.data_ptr() for t in args), y.data_ptr(), R, D, F,
                                           fc, plan.row_tile, plan.split, dev.index,
                                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_chunk_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def bwd_buffers(x, plan: ChunkPlan):
    """The backward's outputs (``mixer_cuda.bwd_outputs``) and the scratch of
    ``plan.bwd``, a dict in the C entries' order (``wsplit`` None without a
    split of the weight-grad products)."""
    scratch = {name: None if spec is None else torch.empty(spec[0], dtype=spec[1], device=x.device)
               for name, spec in plan.bwd.scratch.items()}
    return mixer_cuda.bwd_outputs(x, plan.F), scratch


def chan_ff_chunked_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2, *, fc: int):
    """Gradients of the chunked block: ``chan_ff_chunked_bwd_reference``'s
    contract. On a bf16 CUDA tensor it launches ``chanff_chunk_bwd_rows`` and
    then ``chanff_bwd.cu``'s weight-grad products and column sums, as
    ``chunk_plan`` lays them out; on an f32 one ``mixer_cuda.chan_ff_bwd``'s
    f32 kernels; on a CPU tensor it runs the plain version."""
    global bwd_launches
    if x.device.type == "cpu":
        return chan_ff_chunked_bwd_reference(x, dy, ln_scale, ln_bias, w1, b1, w2, fc=fc)
    if x.device.type != "cuda":
        raise ValueError(f"chan_ff_chunked_bwd runs on cpu or cuda, not {x.device}")
    _check_fc(x, w1, fc)
    if x.dtype == torch.float32:  # as in _forward: the monolithic f32 backward kernel
        return mixer_cuda.chan_ff_bwd(x, dy, ln_scale, ln_bias, w1, b1, w2)
    R, D = x.shape
    F = w1.shape[1]
    args = (x, dy, ln_scale, ln_bias, w1, b1, w2)
    if dy.shape != x.shape or dy.dtype != x.dtype or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError("dy, w1 and w2 must be in x's dtype, dy of x's shape")
    mixer_cuda._cuda_ready("chan_ff_chunked_bwd", args, R, D, F)
    dev = x.device
    plan = chunk_plan(R, F, fc, mixer_cuda._device_sms(dev))
    outs, scratch = bwd_buffers(x, plan)
    rows_scratch = [scratch[k] for k in ("xa", "g1", "da1", "part_d", "part_f")]
    err = _kernel("pips_chanff_chunk_bwd_rows")(
        *(t.data_ptr() for t in args + outs[:1] + tuple(rows_scratch)), R, D, F, fc,
        plan.bwd.row_tile, plan.bwd.split, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"chanff_chunk_bwd_rows kernel launch failed: CUDA error {err}")
    mixer_cuda.bwd_finish(dy, outs, scratch, plan.finish, plan.bwd.row_tile)
    bwd_launches += 1
    return outs


class _ChunkFF(torch.autograd.Function):
    """The custom VJP of ``tools/profile_chanff_chunk.py:make_chunked(fc)``."""

    @staticmethod
    def forward(ctx, fc, x, ln_scale, ln_bias, w1, b1, w2, b2):
        ctx.fc = fc
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2)
        return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, fc)

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dx, dg, db, dw1, db1, dw2, db2 = chan_ff_chunked_bwd(
            x, dy.to(x.dtype).contiguous(), ln_scale, ln_bias, w1.to(x.dtype), b1,
            w2.to(x.dtype), fc=ctx.fc)
        # weight grads in the weights' own dtype: f32 for f32 parameters, as in JAX
        return None, dx, dg, db, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def chan_ff_block_chunked(x, ln_scale, ln_bias, w1, b1, w2, b2, *, fc: int):
    """F-chunked channel block: ``mixer_cuda.chan_ff_block``'s signature and
    weight conventions (w1, w2 in x's dtype or f32, cast inside), F walked in
    chunks of ``fc`` columns, which must divide F. Returns (R, D) in x.dtype,
    with a gradient when any input requires one.

    On CUDA the kernels take D == 512, contiguous, 16-byte-aligned tensors,
    and in bf16 fc in ``FCS``; anything else raises.
    """
    mixer_cuda._check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    _check_fc(x, w1, fc)
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ChunkFF.apply(fc, *args)
    return _forward(x, ln_scale, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2, fc)
