"""Optical-flow chaining tracker, the RAFT baseline's tracking mode
(counterpart of ``pips_tpu/inference/flow_chain.py``; capability parity with
reference ``test_on_flt.py:144-161`` / ``test_on_badja.py:199-217``).

Consecutive-frame flow fields are integrated at each query point's current
position with border-replicating bilinear sampling. The frames go to the
device once, and the flows stay there until the trajectories come back.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.ops.samp import bilinear_sample2d


def chain_flows(flows: torch.Tensor, xy0: torch.Tensor) -> torch.Tensor:
    """flows: (B, S-1, H, W, 2); xy0: (B, N, 2). Returns trajs (B, S, N, 2)."""
    coords = [xy0]
    coord = xy0
    for s in range(flows.shape[1]):
        coord = coord + bilinear_sample2d(flows[:, s], coord[:, :, 0], coord[:, :, 1])
        coords.append(coord)
    return torch.stack(coords, dim=1)


class FlowChainTracker:
    """Track points by integrating per-frame flow (RAFT or any flow fn).

    ``flow_fn(rgb0, rgb1)``: (B, H, W, 3) tensors on ``device`` in
    [-0.5, 0.5] -> flow (B, H, W, 2) on ``device`` (``Raftnet.forward``).
    CUDA unless ``device="cpu"``."""

    def __init__(self, flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 device="cuda"):
        self.flow_fn = flow_fn
        self.device = resolve_device(device)

    def track(self, rgbs: np.ndarray, xy0: np.ndarray) -> np.ndarray:
        """rgbs: (B, S, H, W, 3) in [0, 255]; xy0: (B, N, 2) -> (B, S, N, 2) numpy."""
        with torch.inference_mode():
            prep = torch.from_numpy(np.asarray(rgbs, np.float32)).to(self.device) / 255.0 - 0.5
            flows = torch.stack([self.flow_fn(prep[:, s], prep[:, s + 1]).float()
                                 for s in range(prep.shape[1] - 1)], dim=1)
            xy = torch.from_numpy(np.asarray(xy0, np.float32)).to(self.device)
            return chain_flows(flows, xy).cpu().numpy()
