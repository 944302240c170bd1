"""Double-buffered host-to-device video feed for the chaining engines
(a copy of ``pips_tpu/inference/feed.py``: numpy and threads only).

The reference decodes the WHOLE video before any model work
(``chain_demo.py:104-117`` reads every jpg into one array, then loops), which
serializes host video I/O and device encoding. ``FrameFeed`` runs the
decode/preprocess on a background thread feeding a bounded queue of
fixed-size frame chunks while the device encodes the previous chunk (CUDA
launches are asynchronous, so the encode of chunk k overlaps the decode of
chunks k+1..k+depth): total time is about max(decode, encode) instead of
their sum.

Both chaining engines accept a ``FrameFeed`` (or any iterable of frames)
wherever they accept a decoded ``(T, H, W, 3)`` array.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np


class FrameFeed:
    """Background-decoded, chunked frame stream.

    frames: iterable of (H, W, 3) arrays — or of zero-arg callables
        returning one (lazy decode: pass ``lambda: imread(path)`` per
        frame so even the file read happens on the feed thread).
    chunk: frames per chunk (the encoder's batch; pad tail repeats the
        last frame, matching the engines' window padding).
    depth: max decoded chunks buffered ahead (2 = double buffering).
    transform: per-frame host preprocess (resize/normalize), run on the
        feed thread.

    Iterating yields ``(chunk_array (chunk, H, W, 3) float32, n_valid)``.
    Decode errors propagate to the consumer at the failing chunk.
    """

    def __init__(self, frames: Iterable, chunk: int = 8, depth: int = 2,
                 transform: Optional[Callable] = None):
        if chunk < 1 or depth < 1:
            raise ValueError(f"chunk={chunk} and depth={depth} must be >= 1")
        self.chunk = chunk
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._consumed = False
        self._thread = threading.Thread(
            target=self._work, args=(iter(frames), transform), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts if the consumer closed the feed (so an
        abandoned iteration never leaves the producer blocked forever)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it: Iterator, transform) -> None:
        try:
            buf: list[np.ndarray] = []
            for f in it:
                if callable(f):
                    f = f()
                if transform is not None:
                    f = transform(f)
                f = np.asarray(f, np.float32)
                if f.ndim != 3:
                    raise ValueError(f"frame must be (H, W, C), got {f.shape}")
                buf.append(f)
                if len(buf) == self.chunk:
                    if not self._put((np.stack(buf), self.chunk)):
                        return
                    buf = []
            if buf:
                n = len(buf)
                buf.extend([buf[-1]] * (self.chunk - n))
                if not self._put((np.stack(buf), n)):
                    return
            self._put(None)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
            self._put(None)

    def close(self) -> None:
        """Release the producer thread (idempotent; called automatically
        when iteration finishes, errors, or is abandoned)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        if self._consumed:
            raise RuntimeError(
                "FrameFeed is single-use: its frames were already consumed "
                "(build a new FrameFeed to iterate again)")
        self._consumed = True
        try:
            while True:
                item = self._q.get()
                if item is None:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()


def as_feed(rgbs, chunk: int) -> "FrameFeed | _ArrayChunks":
    """Normalize engine input: a FrameFeed passes through (its chunk size
    wins — it was built before the engine saw it); a decoded (T, H, W, 3)
    array gets a thread-free chunked view (no copy, no feed thread); any
    other iterable of frames (generator, list, live source) is wrapped in
    a FrameFeed."""
    if isinstance(rgbs, FrameFeed):
        return rgbs
    if isinstance(rgbs, np.ndarray) or getattr(rgbs, "ndim", None) == 4:
        return _ArrayChunks(np.asarray(rgbs), chunk)
    return FrameFeed(rgbs, chunk=chunk)


class _ArrayChunks:
    """Chunked iteration over an already-decoded video array — the
    non-streaming fast path (same (chunk, n_valid) protocol, zero threads)."""

    def __init__(self, rgbs: np.ndarray, chunk: int):
        if rgbs.ndim != 4:
            raise ValueError(f"video must be (T, H, W, C), got {rgbs.shape}")
        self.rgbs = rgbs
        self.chunk = chunk

    def __iter__(self):
        T = self.rgbs.shape[0]
        for t0 in range(0, T, self.chunk):
            c = self.rgbs[t0:t0 + self.chunk]
            n = c.shape[0]
            if n < self.chunk:
                c = np.concatenate(
                    [c, np.repeat(c[-1:], self.chunk - n, 0)], 0)
            yield np.asarray(c, np.float32), n
