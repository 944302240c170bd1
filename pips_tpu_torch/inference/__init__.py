from pips_tpu_torch.inference.window import WindowTracker, dense_queries, grid_queries

__all__ = ["WindowTracker", "dense_queries", "grid_queries"]
