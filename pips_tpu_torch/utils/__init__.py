"""Utilities of the train loop (counterpart of ``pips_tpu/utils``): metric
pools, checkpoints, the metric writer and the media summaries."""

from pips_tpu_torch.utils import saverloader
from pips_tpu_torch.utils.pools import MovingAverage, SimplePool

__all__ = ["MovingAverage", "SimplePool", "saverloader"]
