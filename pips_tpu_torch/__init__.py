"""PyTorch/CUDA port of pips_tpu (the JAX package stays as the reference).

Serves PIPs windows: ``make_pips`` builds the model, ``WindowTracker`` runs
it. Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from pips_tpu_torch.inference.window import WindowTracker, dense_queries, grid_queries
from pips_tpu_torch.models.pips import Pips, PipsOutput, init_params, make_pips

__all__ = ["Pips", "PipsOutput", "WindowTracker", "dense_queries", "grid_queries",
           "init_params", "make_pips"]
