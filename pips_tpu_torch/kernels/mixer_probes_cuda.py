"""The three Mosaic probe kernels of ``tools/debug_mixer_kernel.py`` for Hopper.

That tool checked that Mosaic lowers what a fused mixer-block kernel needs:
exact-erf GELU (its ``pallas_call`` at :63), the LayerNorm of a static lane
slice of a wide row (:66) and weights streamed over a grid of 12 blocks into
one f32 accumulator (:69). On a CUDA tensor ``gelu``, ``ln_slice`` and
``stream_accum`` launch their kernels in ``pips_tpu_torch/csrc/mixer_probes.cu``
(whose header says what bounds them); ``gelu_reference``,
``ln_slice_reference`` and ``stream_accum_reference`` are the plain versions,
which repeat the probes' arithmetic in f32 (GELU's in f64, see
``gelu_reference``). A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from pips_tpu_torch.kernels import _build

SLICE = 512  # lanes of x in the probes' LayerNorm and product (the tool's D)
STREAM_COLS = 64  # output columns of a stream_accum block: N must be a multiple
_SQRT2 = math.sqrt(2.0)

launches: collections.Counter = collections.Counter()  # per kernel name; read by chip_smoke.py
_fns: dict[str, object] = {}
# C entry -> (pointer arguments, int arguments); each then takes the device
# index and a stream pointer
_ENTRIES = {"pips_probe_gelu": (2, 1), "pips_probe_ln_slice": (2, 3),
            "pips_probe_stream_accum": (3, 4)}


def gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """``k_erf``'s function, 0.5 x (1 + erf(x / sqrt 2)), in f64 and rounded
    once to bf16. ``k_erf`` computes it in f32, where 1 + erf cancels for
    x << 0 and so carries its erf's absolute error (a few f32 ulps of 1, and
    not the same few in XLA, in PyTorch's f32 erf or in CUDA's ``erff``): in
    f64 the plain version carries none, and each side is held to it alone."""
    xd = x.double()
    return (0.5 * xd * (1.0 + torch.erf(xd / _SQRT2))).to(torch.bfloat16)


def ln_slice_reference(x: torch.Tensor, width: int = SLICE) -> torch.Tensor:
    """``k_ln_slice``: the LayerNorm of lanes 0:width of each row, f32
    statistics with var = E[x^2] - mu^2, eps 1e-5, no affine and no clamp;
    (R, width) bf16."""
    xs = x[:, :width].float()
    mu = xs.mean(1, keepdim=True)
    var = (xs * xs).mean(1, keepdim=True) - mu * mu
    return ((xs - mu) * torch.rsqrt(var + 1e-5)).to(torch.bfloat16)


def stream_accum_reference(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """``k_block_stream`` over its grid: o = sum_b x[:, 0:512] @ w1[b], each
    product of the widened operands (bf16 products are exact in f32) summed in
    f32, and added to o in order; (M, N) f32."""
    xs = x[:, :SLICE].float()
    o = torch.zeros(x.shape[0], w1.shape[2], dtype=torch.float32, device=x.device)
    for b in range(w1.shape[0]):
        o = o + xs @ w1[b].float()
    return o


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/mixer_probes.cu`` (built at first use), typed."""
    fn = _fns.get(name)
    if fn is None:
        n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load("mixer_probes"), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for bf16 CUDA
    tensors with unit lane stride and 16-byte alignment; raises otherwise."""
    x = tensors[0]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"the CUDA {name} takes bfloat16 with unit lane stride, 16-byte "
                             f"aligned; got {t.dtype} with strides {t.stride()}")
    return True


def _launch(name: str, entry: str, *args, device: torch.device) -> None:
    err = _kernel(entry)(*args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU of a bf16 tensor, elementwise: bf16 of x's shape."""
    if not _on_cuda("gelu", x):
        return gelu_reference(x)
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the CUDA gelu takes fewer than 2^31 values, got {x.numel()}")
    x = x.contiguous()
    o = torch.empty_like(x)
    if x.numel():
        _launch("gelu", "pips_probe_gelu", x.data_ptr(), o.data_ptr(), x.numel(), device=x.device)
    return o


def ln_slice(x: torch.Tensor, width: int = SLICE) -> torch.Tensor:
    """The LayerNorm of lanes 0:width of each row of x (R, >= width) bf16, no
    affine: (R, width) bf16."""
    if x.dim() != 2 or not 0 < width <= x.shape[1]:
        raise ValueError(f"ln_slice takes x (R, >= {width}), got {tuple(x.shape)}")
    if not _on_cuda("ln_slice", x):
        return ln_slice_reference(x, width)
    o = torch.empty(x.shape[0], width, dtype=torch.bfloat16, device=x.device)
    if x.shape[0]:
        _launch("ln_slice", "pips_probe_ln_slice", x.data_ptr(), o.data_ptr(), x.shape[0], width,
                x.stride(0), device=x.device)
    return o


def stream_accum(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """sum_b x[:, 0:512] @ w1[b] for x (M, >= 512) and w1 (NB, 512, N) bf16:
    (M, N) f32. On CUDA, N must be a multiple of 64 (the kernel's column
    tile), x's row stride a multiple of 8 and w1 contiguous."""
    if x.dim() != 2 or x.shape[1] < SLICE or w1.dim() != 3 or w1.shape[1] != SLICE:
        raise ValueError(f"stream_accum takes x (M, >= {SLICE}) and w1 (NB, {SLICE}, N), got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    if not _on_cuda("stream_accum", x, w1):
        return stream_accum_reference(x, w1)
    M, (NB, _, N) = x.shape[0], w1.shape
    if N % STREAM_COLS or x.stride(0) % 8 or not w1.is_contiguous():
        raise ValueError(f"the CUDA stream_accum takes N % {STREAM_COLS} == 0, x's row stride "
                         f"% 8 == 0 and a contiguous w1; got N={N}, stride {x.stride(0)}")
    o = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if M:
        _launch("stream_accum", "pips_probe_stream_accum", x.data_ptr(), w1.data_ptr(),
                o.data_ptr(), M, N, NB, x.stride(0), device=x.device)
    return o
