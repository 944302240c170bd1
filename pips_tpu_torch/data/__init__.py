"""Data (counterpart of ``pips_tpu/data``): the synthetic point-tracking set,
the host batcher and the CUDA prefetcher."""

from pips_tpu_torch.data.loader import DevicePrefetcher, batch_iterator
from pips_tpu_torch.data.synthetic import SyntheticPointDataset

__all__ = ["DevicePrefetcher", "SyntheticPointDataset", "batch_iterator"]
