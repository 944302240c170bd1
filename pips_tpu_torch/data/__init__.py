"""Data (counterpart of ``pips_tpu/data``): the synthetic point-tracking set."""

from pips_tpu_torch.data.synthetic import SyntheticPointDataset

__all__ = ["SyntheticPointDataset"]
