"""PyTorch/CUDA port of pips_tpu (the JAX package stays as the reference).

Serves PIPs windows and long videos: ``make_pips`` builds the model and
``Pips2`` is the S-agnostic PIPs++ family; ``WindowTracker`` runs one window,
``ChainTracker`` (host scheduler) and ``ChainTrackerOnDevice`` chain windows
over a video, fed by an array or a ``FrameFeed``; ``FlowChainTracker``
chains the RAFT and DINO baselines. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from pips_tpu_torch.inference import (ChainTracker, ChainTrackerOnDevice, FlowChainTracker,
                                      FrameFeed, WindowTracker, as_feed, dense_queries,
                                      grid_queries, select_skip)
from pips_tpu_torch.kernels.corr_cuda import corr_sample
from pips_tpu_torch.models.pips import Pips, PipsOutput, init_params, make_pips
from pips_tpu_torch.models.pips2 import Pips2

__version__ = "0.1.0"  # the JAX package's version, kept here as its own copy

__all__ = ["ChainTracker", "ChainTrackerOnDevice", "FlowChainTracker", "FrameFeed", "Pips",
           "Pips2", "PipsOutput", "WindowTracker", "__version__", "as_feed", "corr_sample",
           "dense_queries", "grid_queries", "init_params", "make_pips", "select_skip"]
