"""Fused correlation + patch sampling over a feature pyramid, for Hopper.

Counterpart of ``pips_tpu/kernels/corr_pallas.py:corr_sample_pallas``:
``corr_sample`` has the JAX signature and launches the hand-written CUDA
kernel in ``pips_tpu_torch/csrc/corr_sample_fwd.cu`` (which replaces the TPU
kernel ``_corr_sample_kernel``; the source's header says what bounds it and
how its design answers that). ``corr_sample_reference`` is the plain PyTorch
version, ``ops.corr.fused_corr_sample``: the gather form the JAX kernel
matches.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. There is no backward, as the JAX kernel has none: training samples
through ``sample_corr_onehot``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from pips_tpu_torch.kernels import _build, mixer_cuda
from pips_tpu_torch.ops.corr import fused_corr_sample

KERNEL_RADIUS = 3
KERNEL_C = 128  # the channel width the kernel is compiled for (the flagship's latent)
MAX_LEVELS = 8
WARPS = 8  # a block's warps, each on one (frame, point) at a time, its levels in turn
# shared memory by path: a warp's 8 x 8 f32 scores and its target's 16-byte
# words, 32 lanes each (2 words a lane; 6 for an f32 target in three parts)
SMEM = {path: WARPS * (64 * 4 + words * 32 * 16) for path, words in ((1, 2), (2, 6), (0, 2))}
KERNEL = "corr_sample_points"
FILL = 3  # blocks an SM a launch should give the card (the kernel's bounds allow 4)
# (map, target) dtypes -> the C entry's path: the tensor cores, with the f32
# target split in three bf16 parts, and SIMT for f32 maps
PATHS = {(torch.bfloat16, torch.bfloat16): 1, (torch.bfloat16, torch.float32): 2,
         (torch.float32, torch.float32): 0}

launches = 0  # kernel launches so far; read (and reset) by chip_smoke.py
_fn = None

corr_sample_reference = fused_corr_sample

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class CorrPlan:
    """The one launch of a call (``KERNEL``): ``path`` 1 on the tensor cores
    (bf16 maps and targets), 2 on them with the f32 target split in three
    bf16 parts (bf16 maps), 0 SIMT (f32 maps); block (x, y, z) takes
    points ``WARPS`` x .. ``WARPS`` x + 7 of frame y, a warp a point, and its
    levels ``lpw`` z .. ``lpw`` z + ``lpw`` - 1 in turn; ``blocks`` = (x, y,
    z) extents, ``grid`` their product, ``smem`` bytes a block."""
    path: int
    lpw: int
    blocks: tuple
    grid: int
    smem: int


def launch_plan(B: int, S: int, N: int, L: int, map_dtype: torch.dtype,
                tgt_dtype: torch.dtype, sms: int = mixer_cuda.SMS,
                lpw: int | None = None) -> CorrPlan:
    """The launch for B*S frames (at most 65535, the grid's y) of N points
    over L levels on a card of ``sms`` SMs: a warp takes as many levels of
    its point (L, half of them, or one; ``lpw`` forces a count) as still
    leave ``FILL`` blocks an SM: where points are few, one wave of warps,
    each working through few levels; where they are many, a warp a point,
    whose coords and target are loaded once and whose L*49 outputs are
    written together."""
    if min(B, S, N) < 1 or not 1 <= L <= MAX_LEVELS or B * S > 65535 or (
            map_dtype, tgt_dtype) not in PATHS or (lpw is not None and not 1 <= lpw <= L):
        raise ValueError(f"no corr_sample kernel takes B={B}, S={S}, N={N}, L={L}, maps "
                         f"{map_dtype}, targets {tgt_dtype}, {lpw} levels a warp")
    bx = -(-N // WARPS)
    if lpw is None:
        lpw = next((k for k in (L, -(-L // 2)) if bx * B * S * -(-L // k) >= FILL * sms), 1)
    blocks = (bx, B * S, -(-L // lpw))
    path = PATHS[(map_dtype, tgt_dtype)]
    return CorrPlan(path, lpw, blocks, blocks[0] * blocks[1] * blocks[2], SMEM[path])


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("corr_sample_fwd").pips_corr_sample_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(pyramid, targets, coords, radius):
    if targets.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"targets must be (B, S, N, C) and coords (B, S, N, 2), got "
                         f"{tuple(targets.shape)} and {tuple(coords.shape)}")
    B, S, N, C = targets.shape
    if tuple(coords.shape[:3]) != (B, S, N):
        raise ValueError(f"coords {tuple(coords.shape)} do not match targets {tuple(targets.shape)}")
    if not pyramid:
        raise ValueError("the pyramid has no levels")
    for lvl, fm in enumerate(pyramid):
        if (fm.dim() != 5 or tuple(fm.shape[:2]) != (B, S) or fm.shape[-1] != C
                or fm.shape[2] < 1 or fm.shape[3] < 1):
            raise ValueError(f"level {lvl} must be ({B}, {S}, H >= 1, W >= 1, {C}), "
                             f"got {tuple(fm.shape)}")
        if fm.device != targets.device or fm.dtype != pyramid[0].dtype:
            raise ValueError(f"level {lvl} is {fm.dtype} on {fm.device}; level 0 is "
                             f"{pyramid[0].dtype} and targets are on {targets.device}")
    if coords.device != targets.device:
        raise ValueError(f"coords are on {coords.device}, targets on {targets.device}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")


def corr_sample(pyramid: list[torch.Tensor], targets: torch.Tensor, coords: torch.Tensor,
                radius: int = 3) -> torch.Tensor:
    """pyramid: list of (B, S, H_l, W_l, C); targets (B, S, N, C); coords
    (B, S, N, 2) f32 at level-0 scale -> (B, S, N, L*(2r+1)^2) in f32.

    On CUDA the kernel takes radius 3, C = 128, at most 8 levels, (map,
    target) dtypes bf16/bf16, bf16/f32 or f32/f32, contiguous 16-byte-aligned
    maps, targets whose last axis has unit stride and whose (b, s, n) rows are
    16-byte aligned, coords whose last axis has unit stride, and f32 coords;
    anything else raises. Targets and coords may be strided views (an
    expanded first-iteration target is read in place). ``launch_plan`` lays
    out the launch: bf16 maps on the tensor cores (an f32 target split
    exactly in three bf16 parts), f32 maps SIMT. At most 65535 frames B*S;
    a frame's map below 2 GiB.
    """
    global launches
    _check(pyramid, targets, coords, radius)
    if targets.device.type == "cpu":
        return corr_sample_reference(pyramid, targets, coords, radius)
    if targets.device.type != "cuda":
        raise ValueError(f"corr_sample runs on cpu or cuda, not {targets.device}")
    B, S, N, C = targets.shape
    L = len(pyramid)
    md, td = _DTYPE_CODE.get(pyramid[0].dtype), _DTYPE_CODE.get(targets.dtype)
    if radius != KERNEL_RADIUS or C != KERNEL_C or L > MAX_LEVELS:
        raise ValueError(f"CUDA corr_sample takes radius {KERNEL_RADIUS}, C={KERNEL_C} and "
                         f"at most {MAX_LEVELS} levels; got radius {radius}, C={C}, L={L}")
    if md is None or td is None or (md, td) == (0, 1) or coords.dtype != torch.float32:
        raise ValueError(f"CUDA corr_sample takes bf16 or f32 maps with targets of the same "
                         f"dtype or f32, and f32 coords; got maps {pyramid[0].dtype}, targets "
                         f"{targets.dtype}, coords {coords.dtype}")
    for fm in pyramid:
        if not fm.is_contiguous() or fm.data_ptr() % 16:
            raise ValueError("corr_sample's CUDA kernel needs contiguous, 16-byte aligned maps")
        if fm[0, 0].numel() * fm.element_size() >= 2 ** 31:
            raise ValueError(f"corr_sample's CUDA kernel takes a frame's map below 2 GiB, got "
                             f"{tuple(fm.shape[2:])}")
    if targets.stride(-1) != 1 or coords.stride(-1) != 1:
        raise ValueError("corr_sample's CUDA kernel needs unit stride over C and over xy")
    esize = targets.element_size()
    if targets.data_ptr() % 16 or any(st * esize % 16 for st in targets.stride()[:3]):
        raise ValueError("corr_sample's CUDA kernel reads targets by 16 bytes: each (b, s, n) "
                         f"row must be 16-byte aligned; got strides {targets.stride()}")
    out = torch.empty((B, S, N, L * (2 * radius + 1) ** 2), dtype=torch.float32,
                      device=targets.device)
    if out.numel() == 0:
        return out
    maps = (ctypes.c_void_p * L)(*(fm.data_ptr() for fm in pyramid))
    hs = (ctypes.c_int * L)(*(fm.shape[2] for fm in pyramid))
    ws = (ctypes.c_int * L)(*(fm.shape[3] for fm in pyramid))
    tst = (ctypes.c_longlong * 3)(*targets.stride()[:3])
    cst = (ctypes.c_longlong * 3)(*coords.stride()[:3])
    plan = launch_plan(B, S, N, L, pyramid[0].dtype, targets.dtype,
                       mixer_cuda._device_sms(targets.device))
    err = _kernel()(maps, hs, ws, L, targets.data_ptr(), tst, coords.data_ptr(), cst,
                    out.data_ptr(), B, S, N, C, md, td, plan.path, plan.lpw, plan.grid,
                    1.0 / math.sqrt(C),
                    targets.device.index, torch.cuda.current_stream(targets.device).cuda_stream)
    if err:
        raise RuntimeError(f"corr_sample_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out
