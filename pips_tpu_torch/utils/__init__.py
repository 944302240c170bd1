"""Utilities (counterpart of ``pips_tpu/utils``): metric pools, checkpoints,
the metric writer, the media summaries and the formatting helpers."""

from pips_tpu_torch.utils import saverloader
from pips_tpu_torch.utils.format import print_stats, strnum
from pips_tpu_torch.utils.pools import MovingAverage, SimplePool

__all__ = ["MovingAverage", "SimplePool", "print_stats", "saverloader", "strnum"]
