"""The strided row contraction of ``tools/probe_mosaic_ops.py``'s four probes, for Hopper.

That tool checked three Mosaic lowerings for the stem weight-gradient design,
each a contraction of bf16 rows into an f32 product: (24, 256, 6) x
(24, 256, 64) -> (6, 64) with two contracting dims (probe A, its
``pallas_call`` at :46), after collapsing both to 2-D in the kernel (A2, :67)
and through a minor-dim split reshape (B, :89); and 28 (24, 6) tiles of a
concatenated along lanes against b[:, 0] -> (168, 64) (C, :110).

``row_contract(a, b)`` computes ``einsum("grc,gro->gco")`` on (G, R, CA) and
(G, R, CB) bf16 views of any strides whose lanes are contiguous (a batch
stride of 0 repeats b), so the four probes are one kernel,
``pips_tpu_torch/csrc/row_contract.cu`` (whose header says what bounds it):
A, A2 and B are one memory layout on the card, C a strided batch. Each call
is one launch; ``launch_plan`` chooses its path, its blocks and its scratch
on the host. ``row_contract_reference`` is its plain version, in f32. A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import torch

from pips_tpu_torch.kernels import _build

MAX_SPLITS = 8  # blocks a batch's rows are cut over: one portable thread-block cluster
MIN_ROWS = 64  # rows a block takes at least before the rows are cut over another
FAST_ROWS = 1024  # rows a fast-path block stages in shared memory at most
BOX_ROWS = 256  # rows of b in one TMA box at most
FAST_CB = 64  # b's lanes on the fast path: 128-byte rows, one swizzled TMA box wide
FAST_CA = 8  # a's lanes at most on the fast path: one n8 tile
GRID_Y = 65535  # batches along the grid's y; the rest along z

launches: collections.Counter = collections.Counter()  # per probe name; read by chip_smoke.py
_fn = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the path (``fast``: rows staged by TMA and asynchronous
    copies, products on mma.sync; else the SIMT walk), ``splits`` blocks of
    ``rows_per_block`` rows per batch (a thread-block cluster), the grid, and
    the general path's f32 scratch for the cluster's partial sums (None when
    it needs none)."""
    fast: bool
    splits: int
    rows_per_block: int
    grid: tuple[int, int, int]
    scratch: Optional[tuple[int, int, int, int]]


def launch_plan(G: int, R: int, CA: int, CB: int, a_strides: tuple[int, int],
                b_strides: tuple[int, int], a_align: int = 16, b_align: int = 16) -> Plan:
    """The kernel's launch for a (G, R, CA) and b (G, R, CB) with batch and
    row strides ``a_strides`` and ``b_strides`` (elements) and data pointers
    aligned to ``a_align`` and ``b_align`` bytes. The fast path takes even CA
    up to 8, CB of 64, a's rows in 4-byte pieces, b's rows as one TMA map (a
    row stride of whole 16 bytes, a batch stride of whole rows) and at most
    ``MAX_SPLITS * FAST_ROWS`` rows; any other shape goes to the general
    path, on the card all the same."""
    (a_bs, a_rs), (b_bs, b_rs) = a_strides, b_strides
    fast = (CA <= FAST_CA and CA % 2 == 0 and CB == FAST_CB and a_align % 4 == 0
            and a_bs % 2 == 0 and a_rs % 2 == 0 and b_align % 16 == 0 and b_rs > 0
            and b_rs % 8 == 0 and b_bs % b_rs == 0 and R <= MAX_SPLITS * FAST_ROWS)
    splits = min(MAX_SPLITS, -(-R // MIN_ROWS))
    rows = -(-R // splits)
    if fast:  # whole k-steps of the product, whole TMA boxes
        step = 16 if rows <= BOX_ROWS else BOX_ROWS
        rows = -(-rows // step) * step
    splits = -(-R // rows)  # every block holds at least one row
    scratch = (splits, G, CA, CB) if splits > 1 and not fast else None
    return Plan(fast, splits, rows, (splits, min(G, GRID_Y), -(-G // GRID_Y)), scratch)


def row_contract_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[g, c, o] = sum_r a[g, r, c] * b[g, r, o] on the widened operands
    (bf16 products are exact in f32), summed in f32; (G, CA, CB) f32."""
    return torch.einsum("grc,gro->gco", a.float(), b.float())


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("row_contract").pips_row_contract
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides t's data address."""
    addr = t.data_ptr()
    return 16 if addr % 16 == 0 else addr & -addr


def row_contract(a: torch.Tensor, b: torch.Tensor, probe: str = "") -> torch.Tensor:
    """``row_contract_reference``'s contract for a (G, R, CA) and b
    (G, R, CB), bf16 on CUDA with unit lane stride and non-negative strides.
    ``probe`` names the caller, under which ``launches`` counts the launch."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[:2] != b.shape[:2]:
        raise ValueError(f"row_contract takes a (G, R, CA) and b (G, R, CB), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return row_contract_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"row_contract runs on cpu or cuda, not {a.device}")
    G, R, CA = a.shape
    CB = b.shape[2]
    for t in (a, b):
        if t.dtype != torch.bfloat16 or t.stride(2) != 1 or min(t.stride()) < 0:
            raise ValueError(f"the CUDA row_contract takes bfloat16 with unit lane stride, got "
                             f"{t.dtype} with strides {t.stride()}")
        span = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        if t.storage_offset() + span >= 2 ** 31:
            raise ValueError("the CUDA row_contract takes offsets below 2^31")
    out = torch.empty(G, CA, CB, dtype=torch.float32, device=a.device)
    if out.numel() == 0 or R == 0:
        return out.zero_()
    plan = launch_plan(G, R, CA, CB, (a.stride(0), a.stride(1)), (b.stride(0), b.stride(1)),
                       _alignment(a), _alignment(b))
    part = None if plan.scratch is None else torch.empty(plan.scratch, dtype=torch.float32,
                                                         device=a.device)
    dev = a.device
    err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), G, R, CA, CB, a.stride(0),
                    a.stride(1), b.stride(0), b.stride(1), int(plan.fast), plan.splits,
                    plan.rows_per_block, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"row_contract kernel launch failed: CUDA error {err}")
    launches[probe] += 1
    return out
