"""Host-side batching and device prefetch (counterpart of ``pips_tpu/data/loader.py``).

``batch_iterator`` is a copy of the JAX package's (numpy only): a pool of
threads or processes decodes samples ahead, and a seed fixes the order.
``DevicePrefetcher`` is rebuilt for CUDA: a background thread stacks each
batch into pinned host tensors and copies them to the card with
``non_blocking=True`` on a side stream, so the copy of the next batch
overlaps the current step; the consumer's stream waits on that copy's event
before it uses the batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

# -- process-worker plumbing (module-level: must pickle by reference) -------
_WORKER_DS = None


def _proc_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _proc_fetch(i: int):
    sample, gotit = _WORKER_DS[i]
    return sample if gotit else None


def _make_pool(dataset, num_workers: int, use_processes: bool):
    if not use_processes:
        return ThreadPoolExecutor(max_workers=num_workers)
    # Spawn (not fork): the parent holds a CUDA context, which does not
    # survive fork. Each worker imports the data modules fresh; per-index
    # seeding keeps samples deterministic whichever worker runs them.
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=num_workers,
                               mp_context=mp.get_context("spawn"),
                               initializer=_proc_init, initargs=(dataset,))


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 125,
                   num_workers: int = 8, grad_acc: int = 1,
                   use_processes: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked batches, honoring the (sample, gotit) retry protocol.

    Parallelism is across batches: a rolling window of in-flight sample
    futures keeps all workers busy whatever the batch size. Results are
    consumed in submission order, so sequential mode still visits every index
    exactly once per epoch with failed samples dropping out, and a fixed seed
    yields a deterministic sample sequence.

    ``use_processes=True`` swaps the thread pool for spawned worker
    processes (decode/augment work is partly GIL-bound).

    With grad_acc > 1, batches get a leading (grad_acc,) microbatch axis.
    """
    from collections import deque

    rng = np.random.RandomState(seed)
    order_idx = 0
    pool = _make_pool(dataset, num_workers, use_processes)
    eff_batch = batch_size * grad_acc
    # in-flight pre-decoded samples: enough to saturate the workers and cover
    # one batch; bounded to cap host RAM
    depth = max(eff_batch, num_workers) + num_workers
    inflight: deque = deque()

    def next_index() -> int:
        nonlocal order_idx
        if shuffle:
            # VIRTUAL index: i + salt*len. Datasets wrap for sample selection
            # but seed their rng from the full value, so a small dataset seen
            # for many epochs gets fresh crops/augs/point-subsets each visit
            # while the stream stays a pure function of `seed`. Sequential
            # mode keeps plain wrapping so eval passes see each sample at its
            # canonical index.
            i = int(rng.randint(0, len(dataset)))
            salt = int(rng.randint(0, 1 << 16))
            return i + salt * len(dataset)
        i = order_idx % len(dataset)
        order_idx += 1
        return i

    def fetch(i: int):
        sample, gotit = dataset[i]
        return sample if gotit else None

    submit_fn = _proc_fetch if use_processes else fetch

    try:
        while True:
            samples = []
            while len(samples) < eff_batch:
                while len(inflight) < depth:
                    inflight.append(pool.submit(submit_fn, next_index()))
                s = inflight.popleft().result()
                if s is not None:
                    samples.append(s)
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            if grad_acc > 1:
                batch = {k: v.reshape(grad_acc, batch_size, *v.shape[1:])
                         for k, v in batch.items()}
            yield batch
    finally:
        # generator .close() (GeneratorExit at the yield) lands here: tear the
        # worker pool down so in-flight decode work stops taking cores
        pool.shutdown(wait=False, cancel_futures=True)


class DevicePrefetcher:
    """Background thread moving host batches onto ``device``, ``depth`` ahead.

    On CUDA each batch becomes pinned host tensors copied with
    ``non_blocking=True`` on a side stream; ``__next__`` makes the caller's
    current stream wait on the copy's event and records the batch's tensors
    on that stream (``record_stream``), so the caller never reads a batch
    still in flight and the caching allocator never hands its memory out
    while the caller's kernels use it. On the CPU it is a plain move. Yields
    dicts of f32 tensors.
    """

    def __init__(self, it: Iterator, device="cuda", depth: int = 2):
        self.it = it
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
                for k, v in batch.items()}
        if self.stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return out, copied

    def _worker(self):
        try:
            for batch in self.it:
                if self._stop.is_set():
                    return
                self.q.put(self._put(batch))
        except Exception as e:  # surface errors on the consumer side
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        batch, copied = item
        if copied is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            for v in batch.values():
                v.record_stream(consumer)
        return batch

    def close(self):
        self._stop.set()
        # a worker blocked on a full queue can't observe the stop flag —
        # drain so it unblocks, then close the source iterator so its
        # finally-block (worker-pool shutdown) runs
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5)
        if not self.thread.is_alive() and hasattr(self.it, "close"):
            self.it.close()
