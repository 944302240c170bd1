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
A, A2 and B are one memory layout on the card, C a strided batch.
``row_contract_reference`` is its plain version, in f32. A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from pips_tpu_torch.kernels import _build

ROWS_PER_SPLIT = 64  # rows one block sums before the partials are added in order

launches: collections.Counter = collections.Counter()  # per probe name; read by chip_smoke.py
_fn = None


def row_contract_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[g, c, o] = sum_r a[g, r, c] * b[g, r, o] on the widened operands
    (bf16 products are exact in f32), summed in f32; (G, CA, CB) f32."""
    return torch.einsum("grc,gro->gco", a.float(), b.float())


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("row_contract").pips_row_contract
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    splits = -(-R // ROWS_PER_SPLIT)
    part = torch.empty(splits, G, CA, CB, dtype=torch.float32, device=a.device) if splits > 1 \
        else None
    dev = a.device
    err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), G, R, CA, CB, a.stride(0),
                    a.stride(1), b.stride(0), b.stride(1), splits, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"row_contract kernel launch failed: CUDA error {err}")
    launches[probe] += 1
    return out
