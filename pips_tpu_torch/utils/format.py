"""Small formatting and debug helpers (a copy of ``pips_tpu/utils/format.py``;
reference ``utils/basic.py:9-36``)."""

from __future__ import annotations

import numpy as np
import torch


def print_stats(name: str, tensor) -> None:
    """min/mean/max + shape one-liner for any array-like (a tensor is read
    on the host; bf16, which numpy lacks, as f32)."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().cpu()
        tensor = (tensor.float() if tensor.dtype == torch.bfloat16 else tensor).numpy()
    t = np.asarray(tensor)
    print(f"{name} ({t.dtype}) min = {t.min():.2f}, mean = {t.mean():.2f}, "
          f"max = {t.max():.2f}", tuple(t.shape))


def strnum(x) -> str:
    s = f"{x:g}"
    if "." in s and abs(x) < 1.0:
        s = s[s.index("."):]
    return s


def get_lr_str(lr: float) -> str:
    lrn = f"{lr:.1e}"
    return lrn[0] + lrn[3:5].lstrip("0") + lrn[-1]
