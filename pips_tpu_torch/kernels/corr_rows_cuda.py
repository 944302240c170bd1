"""The integer correlation patch of ``tools/debug_pallas7.py`` for Hopper.

That tool checked that Mosaic lowers a 3-D broadcast-multiply and axis
reduction, the row-wise form of the corr patch (its ``pallas_call`` at :15,
body ``k_rows``): for each point, the dot products of its target with the map
pixels of an integer (2r+2)^2 window around floor(coords), x-major, of which
the first (2r+1)^2 are kept, zero off the map. On a CUDA tensor
``corr_rows`` launches the kernel in ``pips_tpu_torch/csrc/corr_rows.cu``
(whose header says what bounds it); ``corr_rows_reference`` is its plain
version, in f32 without a matmul (so no TF32). This is not
``corr_sample``'s layout: no bilinear weights, no scale, and the x-major
order. A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pips_tpu_torch.kernels import _build

COORD_LIMIT = 1.0e8  # coordinates not below this in magnitude (NaN too) are off every map

launches = 0  # kernel launches so far; read (and reset) by chip_smoke.py
_fn = None


def _window(coords: torch.Tensor, H: int, W: int, radius: int):
    """Per output k = b * G + a of each point: the flat map row
    (y0 - r + a) * W + (x0 - r + b), clamped onto the map, and whether it
    lies on it; both (S, N, P * P)."""
    G, P = 2 * radius + 2, 2 * radius + 1
    k = torch.arange(P * P, device=coords.device)
    finite = (coords.abs() < COORD_LIMIT).all(-1, keepdim=True)
    c = torch.where(finite, coords, torch.zeros_like(coords))
    x0, y0 = (torch.floor(c[..., i:i + 1]).long() for i in (0, 1))
    xx, yy = x0 - radius + k // G, y0 - radius + k % G
    valid = finite & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
    return yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1), valid


def corr_rows_reference(fmap: torch.Tensor, targets: torch.Tensor, coords: torch.Tensor, H: int,
                        W: int, radius: int = 3) -> torch.Tensor:
    """``k_rows``: fmap (S, H*W, C), targets (S, N, C), coords (S, N, 2) xy;
    returns (S, N, (2r+1)^2) f32, each entry the f32 sum over C of the
    elementwise products with the gathered map row, zero off the map."""
    S, N, C = targets.shape
    idx, valid = _window(coords, H, W, radius)
    rows = torch.gather(fmap.float(), 1, idx.reshape(S, -1, 1).expand(-1, -1, C))
    out = (rows.reshape(S, N, -1, C) * targets.float()[:, :, None, :]).sum(-1)
    return torch.where(valid, out, torch.zeros_like(out))


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("corr_rows").pips_corr_rows
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def corr_rows(fmap: torch.Tensor, targets: torch.Tensor, coords: torch.Tensor, H: int, W: int,
              radius: int = 3) -> torch.Tensor:
    """The integer patch of each point: ``corr_rows_reference``'s contract.
    On CUDA all three inputs are f32."""
    global launches
    S, N, C = targets.shape
    if (fmap.dim() != 3 or tuple(fmap.shape) != (S, H * W, C) or tuple(coords.shape) != (S, N, 2)
            or radius < 0):
        raise ValueError(f"corr_rows takes fmap (S, H*W, C), targets (S, N, C), coords (S, N, 2) "
                         f"with H={H}, W={W}; got {tuple(fmap.shape)}, {tuple(targets.shape)}, "
                         f"{tuple(coords.shape)}")
    if fmap.device != targets.device or coords.device != targets.device:
        raise ValueError("fmap, targets and coords must be on one device")
    if fmap.device.type == "cpu":
        return corr_rows_reference(fmap, targets, coords, H, W, radius)
    if fmap.device.type != "cuda":
        raise ValueError(f"corr_rows runs on cpu or cuda, not {fmap.device}")
    if any(t.dtype != torch.float32 for t in (fmap, targets, coords)):
        raise ValueError("the CUDA corr_rows takes float32 fmap, targets and coords")
    if fmap.numel() >= 2 ** 31:
        raise ValueError("the CUDA corr_rows takes a map of fewer than 2^31 values")
    fmap, targets, coords = (t.contiguous() for t in (fmap, targets, coords))
    out = torch.empty(S, N, (2 * radius + 1) ** 2, dtype=torch.float32, device=fmap.device)
    dev = fmap.device
    err = _kernel()(fmap.data_ptr(), targets.data_ptr(), coords.data_ptr(), out.data_ptr(), S, N,
                    H, W, C, radius, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"corr_rows kernel launch failed: CUDA error {err}")
    launches += 1
    return out
