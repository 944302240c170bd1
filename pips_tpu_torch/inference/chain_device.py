"""Visibility-aware chaining with the loop state on the device
(counterpart of ``pips_tpu/inference/chain_device.py``).

The host-scheduled ``ChainTracker`` refines, at each window start, only the
points that start there, and keeps its state on the host. This variant keeps
the whole state on the device, as the JAX version's ``lax.while_loop`` does:

  * state: per-point window start ``cur``, trajectory and visibility buffers,
    done flags; the appearance features are sampled once from frame 0 (the
    reference's first-window init) and carried;
  * each step picks the earliest pending start t = min(cur | !done), gathers
    the shared S-frame feature window (last-frame padding by index clipping),
    refines ALL N points at that window, and commits results only for the
    points whose ``cur == t``;
  * the skip rule runs on the device (``select_skip_torch``, the closed form
    of the JAX version's ``select_skip_jnp``).

The number of steps is the number of distinct visited starts, as with the
host scheduler. Every step pays for all N points instead of the points that
start there. PyTorch has no device-side while loop, so the loop condition
costs one host sync per start; everything else stays on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pips_tpu_torch.inference.feed import as_feed
from pips_tpu_torch.inference.window import WindowTracker
from pips_tpu_torch.models.pips import Pips
from pips_tpu_torch.ops.samp import bilinear_sample2d


def select_skip_torch(vis_prob: torch.Tensor, S: int, thr_init: float = 0.9,
                      thr_decay: float = 0.02, si_earliest: int = 1) -> torch.Tensor:
    """Tensor version of ``chain.select_skip``, in f32 on the input's device.
    vis_prob: (N, S) -> (N,) int32.

    Transcribes ``select_skip_jnp``: the closed-form decay count with its
    ``+1e-9`` and a one-step correction where the threshold lands on vmax.
    """
    cand = vis_prob[:, si_earliest + 1:]
    vmax = cand.max(dim=1).values
    k = torch.clamp_min(torch.ceil((thr_init - vmax) / thr_decay + 1e-9), 0.0)
    thr = thr_init - k * thr_decay
    thr = torch.where(thr >= vmax, thr - thr_decay, thr)
    si = torch.arange(si_earliest + 1, S, device=vis_prob.device)
    accept = cand > thr[:, None]
    return torch.where(accept, si[None], -1).max(dim=1).values.to(torch.int32)


class ChainTrackerOnDevice:
    """Track N points through a T-frame video with the chaining state on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``max_starts`` caps the number of window starts; ``fixed_skip`` replaces
    the visibility rule by a constant advance (a testing hook).
    """

    def __init__(self, model: Pips, iters: int = 6, corr_mode: str = "onehot",
                 max_starts: Optional[int] = None, fixed_skip: Optional[int] = None,
                 device="cuda"):
        self.tracker = WindowTracker(model, iters=iters, corr_mode=corr_mode, device=device)
        self.model = self.tracker.model
        self.max_starts = max_starts
        self.fixed_skip = fixed_skip

    def encode_video(self, rgbs, chunk: int = 8) -> torch.Tensor:
        """rgbs: (T, H, W, 3) array, frame iterable or ``FrameFeed`` ->
        fmaps (T, H8, W8, C) on the tracker's device."""
        parts = [self.tracker.encode(c[None])[0][:n] for c, n in as_feed(rgbs, chunk)]
        return torch.cat(parts, dim=0)

    @torch.inference_mode()
    def _chain(self, fmaps: torch.Tensor, xys: torch.Tensor):
        """fmaps: (T, H8, W8, C); xys: (N, 2) -> trajs (T, N, 2), vis (T, N)."""
        model = self.model
        T, S, N = fmaps.shape[0], model.S, xys.shape[0]
        dev = fmaps.device
        stride = float(model.stride)
        feat = bilinear_sample2d(fmaps[None, 0], xys[None, :, 0] / stride,
                                 xys[None, :, 1] / stride)[0]  # (N, C)

        # buffers padded by S frames so window writes never clip
        trajs = torch.zeros((T + S, N, 2), dtype=torch.float32, device=dev)
        trajs[0] = xys
        vis = torch.zeros((T + S, N), dtype=torch.float32, device=dev)
        cur = torch.zeros((N,), dtype=torch.int64, device=dev)
        done = torch.zeros((N,), dtype=torch.bool, device=dev)
        steps = torch.arange(S, device=dev)
        bound = self.max_starts if self.max_starts else T

        it = 0
        while it < bound and not bool(done.all()):  # the one host sync per start
            t = torch.where(done, T, cur).min()
            fm_win = fmaps[(t + steps).clamp(0, T - 1)][None]  # (1, S, H8, W8, C)
            q = trajs[cur, torch.arange(N, device=dev)]  # each point's estimate at ITS start
            out = model.track(fm_win, q[None], feat_init=feat[None], iters=self.tracker.iters,
                              is_train=False, corr_mode=self.tracker.corr_mode)
            coords = out.coord_predictions[-1][0]  # (S, N, 2)
            vis_p = torch.sigmoid(out.vis_e[0].float())  # (S, N)

            active = (cur == t) & ~done
            rows = t + steps  # < T + S
            trajs[rows] = torch.where(active[None, :, None], coords, trajs[rows])
            vis[rows] = torch.where(active[None, :], vis_p, vis[rows])

            if self.fixed_skip is not None:
                skips = torch.full((N,), self.fixed_skip, dtype=torch.int64, device=dev)
            else:
                skips = select_skip_torch(vis_p.T, S).long()
            nxt = t + skips
            cur = torch.where(active, nxt, cur)
            done = done | (active & (nxt >= T))
            it += 1
        return trajs[:T], vis[:T]

    def track_video(self, rgbs, xys: np.ndarray):
        """rgbs: (T, H, W, 3) [0, 255] or a ``FrameFeed``; xys: (N, 2)
        -> numpy (trajs (T, N, 2), vis (T, N))."""
        fmaps = self.encode_video(rgbs)
        trajs, vis = self._chain(fmaps, torch.as_tensor(xys, dtype=torch.float32)
                                 .to(fmaps.device))
        return trajs.cpu().numpy(), vis.cpu().numpy()
