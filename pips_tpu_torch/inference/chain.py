"""Visibility-aware chaining over long videos
(counterpart of ``pips_tpu/inference/chain.py``).

The reference tracks each point sequentially through its own sliding-window
loop (``chain_demo.py:40-83``): O(N * windows) model calls. Here, as in the
JAX package:

  1. all T frames are encoded once, in chunks; windows are slices of the
     feature stack, since the encoder is per-frame (padding a window by
     repeating the last frame equals repeating its feature);
  2. a host scheduler walks window starts t in increasing order; every point
     whose window starts at t is refined in one batched call (groups of at
     most ``capacity`` points), sharing the window's features;
  3. the skip rule (the latest frame in [2..S-1] whose sigmoid(vis) clears a
     threshold decaying from 0.9 by 0.02 per failed sweep) runs on the host
     in closed form per point.

Per point the semantics are the reference's: the window's queries are the
current estimate at the window start, the appearance feature of the first
window is carried, and windows past the end repeat the last frame.

The JAX version pads each group to a power-of-two bucket so that its jit
caches stay bounded. PyTorch runs eagerly and each point is refined
independently, so the port runs every group at its own size.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from pips_tpu_torch.inference.feed import as_feed
from pips_tpu_torch.inference.window import WindowTracker
from pips_tpu_torch.models.pips import Pips
from pips_tpu_torch.models.pips2 import Pips2


def select_skip(vis_prob: np.ndarray, S: int = 8, thr_init: float = 0.9,
                thr_decay: float = 0.02, si_earliest: int = 1) -> np.ndarray:
    """Vectorized reference skip rule (``chain_demo.py:63-79``), transcribed
    from the JAX package.

    vis_prob: (..., S) sigmoid visibilities. Returns (...) int skip.

    The reference scans si from S-1 down; si == si_earliest triggers a
    threshold decay and a rescan, so acceptance is the largest si in
    [si_earliest+1, S-1] with vis[si] > thr at the first threshold where any
    such si exists. The reference compares in float32, so the decayed
    threshold is cast to float32 here too: a float64 compare flips ties where
    vis sits within one f32 ulp of thr. The closed-form decay count k0 can be
    off by one at those same boundaries, so acceptance is evaluated at
    {k0-1, k0, k0+1} and the smallest accepting level wins (k0+1 always
    accepts: its threshold is a full decay step below vmax).
    """
    cand = np.asarray(vis_prob, np.float32)[..., si_earliest + 1:]
    vmax = cand.max(axis=-1).astype(np.float64)
    # real-arithmetic estimate: smallest k >= 0 with thr_init - k*decay <= vmax
    k0 = np.maximum(np.ceil((thr_init - vmax) / thr_decay), 0).astype(np.int64)
    ks = np.stack([np.maximum(k0 - 1, 0), k0, k0 + 1])  # (3, ...)
    # threshold after k decays, by repeated f64 subtraction like the reference
    # loop: `thr_init - k*decay` drifts ~k*eps from it, enough to flip a
    # strict > against ties (e.g. 0.5 - 5x0.1 = 2.8e-17, not 0.0)
    seq = np.empty(int(ks.max()) + 1, np.float64)
    t = float(thr_init)
    for j in range(seq.shape[0]):
        seq[j] = t
        t -= thr_decay
    thr32 = seq[ks].astype(np.float32)
    acc = cand[None] > thr32[..., None]  # (3, ..., C) float32 compare
    any_acc = acc.any(axis=-1)
    first = np.argmax(any_acc, axis=0)  # smallest accepting level (ks ascend)
    acc_first = np.take_along_axis(acc, first[None, ..., None], axis=0)[0]
    si = np.arange(si_earliest + 1, S)
    # largest accepted si at that threshold level
    return np.where(acc_first, si, -1).max(axis=-1)


class ChainTracker:
    """Track N points through a T-frame video by chaining S-frame windows of
    ``model`` on ``device`` (CUDA unless the caller asks for the CPU).

    ``select_fn(vis (K, S), S) -> (K,)`` picks each point's next window start
    offset, in [1, S-1]; the default is ``select_skip``. ``record_starts``
    keeps each point's window starts in ``last_window_starts``. ``S`` is the
    window length: ``Pips`` fixes it (``model.S``), the S-agnostic ``Pips2``
    takes any (``S=``, default 8), as in JAX.
    """

    def __init__(self, model: Pips | Pips2, iters: int = 6, capacity: int = 256,
                 corr_mode: str = "onehot", encode_chunk: int = 8, select_fn=None,
                 S: Optional[int] = None, record_starts: bool = False, device="cuda"):
        self.record_starts = record_starts
        self.S = S or getattr(model, "S", 8)
        self.capacity = capacity
        self.encode_chunk = encode_chunk
        self.select_fn = select_fn or select_skip
        self.tracker = WindowTracker(model, iters=iters, corr_mode=corr_mode, device=device)
        self.last_window_starts = None
        self.stream_peak_chunks = 0

    def encode_video(self, rgbs) -> torch.Tensor:
        """rgbs: (T, H, W, 3) array, frame iterable or ``FrameFeed`` ->
        fmaps (T, H8, W8, C) on the tracker's device."""
        chunks = [self.tracker.encode(c[None])[0][:n]
                  for c, n in as_feed(rgbs, self.encode_chunk)]
        return torch.cat(chunks, dim=0)

    def _window_fmaps(self, fmaps: torch.Tensor, t: int) -> torch.Tensor:
        """(S, H8, W8, C) window starting at t, repeating the last frame past T."""
        T = fmaps.shape[0]
        idx = np.minimum(np.arange(t, t + self.S), T - 1)
        return fmaps[torch.from_numpy(idx).to(fmaps.device)]

    def _start(self, N: int, C: int, T: int):
        trajs = np.zeros((T, N, 2), np.float32)
        vis_out = np.zeros((T, N), np.float32)
        feats = np.zeros((N, C), np.float32)
        has_feat = np.zeros(N, bool)
        self.last_window_starts = [[] for _ in range(N)] if self.record_starts else None
        queue: dict[int, list[int]] = defaultdict(list)
        queue[0] = list(range(N))
        return trajs, vis_out, feats, has_feat, queue

    def track_video(self, rgbs, xys: np.ndarray):
        """rgbs: (T, H, W, 3) float [0, 255], or a ``FrameFeed`` streaming the
        frames; xys: (N, 2) frame-0 queries.

        Returns numpy (trajs (T, N, 2), vis (T, N) probabilities).
        """
        fmaps = self.encode_video(rgbs)
        T, C = int(fmaps.shape[0]), int(fmaps.shape[-1])
        N = xys.shape[0]
        trajs, vis_out, feats, has_feat, queue = self._start(N, C, T)
        trajs[0] = xys
        for t in range(T):  # starts are monotone, each < T
            pts = queue.pop(t, None)
            if not pts:
                continue
            fm_win = self._window_fmaps(fmaps, t)[None]  # (1, S, H8, W8, C)
            self._run_window(fm_win, t, pts, T, trajs, vis_out, feats, has_feat, queue)
        return trajs, vis_out

    def _run_window(self, fm_win, t: int, pts: list[int], T: int,
                    trajs, vis_out, feats, has_feat, queue) -> None:
        """Refine every point whose window starts at t (in groups of at most
        ``capacity``), write results into trajs/vis_out in place, and requeue
        each point at its next start (< T).

        ``feats`` is a host f32 array, as in the JAX version: from the second
        window on, the first iteration's targets are f32 against the
        compute-dtype pyramid."""
        S = self.S
        S_local = min(S, T - t)
        if self.last_window_starts is not None:
            for g in pts:
                self.last_window_starts[g].append(t)
        for i0 in range(0, len(pts), self.capacity):
            group = pts[i0:i0 + self.capacity]
            q = trajs[t, group][None]  # (1, K, 2)
            if has_feat[group].all():
                f = torch.from_numpy(feats[group][None]).to(self.tracker.device)
                coords, vis_e, _ = self.tracker.track(fm_win, q, f)
            else:
                assert not has_feat[group].any(), "mixed feat groups impossible: all start at t=0"
                coords, vis_e, ffeat = self.tracker.track(fm_win, q)
                feats[group] = ffeat[0].float().cpu().numpy()
                has_feat[group] = True
            coords = coords[0].float().cpu().numpy()  # (S, K, 2)
            vis_p = 1.0 / (1.0 + np.exp(-vis_e[0].float().cpu().numpy()))  # (S, K)

            trajs[t:t + S_local, group] = coords[:S_local]
            vis_out[t:t + S_local, group] = vis_p[:S_local]

            if t + 1 >= T:
                continue
            skips = np.asarray(self.select_fn(vis_p.T, S=S))  # (K,)
            if ((skips < 1) | (skips > S - 1)).any():
                # both engines assume forward progress bounded by the window
                # (track_stream's eviction and pre-EOF requeue depend on it)
                raise ValueError(f"select_fn must return skips in [1, {S - 1}], got "
                                 f"range [{skips.min()}, {skips.max()}]")
            # vectorized requeue: bucket points by next window start
            nxts = t + skips.astype(np.int64)
            ids = np.asarray(group, np.int64)[nxts < T]
            nxts = nxts[nxts < T]
            order = np.argsort(nxts, kind="stable")
            ids, nxts = ids[order], nxts[order]
            uniq, starts = np.unique(nxts, return_index=True)
            for u, bucket in zip(uniq, np.split(ids, starts[1:])):
                queue[int(u)].extend(bucket.tolist())

    def track_stream(self, frames, xys: np.ndarray):
        """Online chaining over a frame stream, in bounded device memory.

        Each window is refined as soon as its S frames are encoded, and
        encoded features behind the earliest pending window start are
        evicted: the device holds O(S + encode_chunk) frames of features
        instead of all T (``track_video`` keeps the whole (T, H8, W8, C)
        stack), so long or live videos track in bounded memory.
        ``stream_peak_chunks`` records the most feature chunks held at once.

        frames: a ``FrameFeed``, any iterable of (H, W, 3) frames, or a decoded
        (T, H, W, 3) array. xys: (N, 2) frame-0 queries. Returns
        (trajs (T, N, 2), vis (T, N)), equal to ``track_video(same frames,
        xys)``: the same windows, queries and skip rule (window starts advance
        monotonically, which is also what makes eviction safe).
        """
        S = self.S
        N = xys.shape[0]
        feed = as_feed(frames, self.encode_chunk)
        ck = feed.chunk  # a caller-built FrameFeed's own chunk size wins
        it = iter(feed)
        self.stream_peak_chunks = 0

        store: dict[int, torch.Tensor] = {}  # chunk idx -> (ck, H8, W8, C)
        state = {"T": 0, "eof": False}

        def encode_next():
            try:
                c, n = next(it)
            except StopIteration:
                state["eof"] = True
                return
            if state["T"] % ck:
                raise ValueError("feed yielded a short chunk before the end of the stream")
            store[state["T"] // ck] = self.tracker.encode(c[None])[0]
            state["T"] += n

        encode_next()
        if state["T"] == 0:
            raise ValueError("empty frame stream")
        C = store[0].shape[-1]
        trajs, vis_out, feats, has_feat, queue = self._start(N, C, max(2 * ck, S))
        trajs[0] = xys

        while queue:
            t = min(queue)
            while not state["eof"] and state["T"] < t + S:
                encode_next()
            T_enc = state["T"]
            if t >= T_enc:  # starts past the final frame (safety net)
                break
            if t + S > trajs.shape[0]:  # grow host output buffers
                grow = max(trajs.shape[0], t + S - trajs.shape[0])
                trajs = np.concatenate([trajs, np.zeros((grow, N, 2), np.float32)])
                vis_out = np.concatenate([vis_out, np.zeros((grow, N), np.float32)])
            # before EOF a full window is guaranteed (loop above), and every
            # next start < t + S, so passing T = t + S makes _run_window's
            # S_local/requeue logic exact without knowing the final length
            T_arg = T_enc if state["eof"] else t + S
            idx = np.minimum(np.arange(t, t + S), T_enc - 1)
            fm_win = torch.stack([store[i // ck][i % ck] for i in idx])[None]
            self._run_window(fm_win, t, queue.pop(t), T_arg, trajs, vis_out, feats,
                             has_feat, queue)
            self.stream_peak_chunks = max(self.stream_peak_chunks, len(store))
            if queue:  # evict feature chunks behind the earliest pending start
                tmin = min(queue)
                for k in [k for k in store if (k + 1) * ck <= tmin]:
                    del store[k]
        return trajs[:state["T"]], vis_out[:state["T"]]
