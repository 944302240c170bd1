from pips_tpu_torch.inference.chain import ChainTracker, select_skip
from pips_tpu_torch.inference.chain_device import ChainTrackerOnDevice, select_skip_torch
from pips_tpu_torch.inference.feed import FrameFeed, as_feed
from pips_tpu_torch.inference.window import WindowTracker, dense_queries, grid_queries

__all__ = ["ChainTracker", "ChainTrackerOnDevice", "FrameFeed", "WindowTracker", "as_feed",
           "dense_queries", "grid_queries", "select_skip", "select_skip_torch"]
