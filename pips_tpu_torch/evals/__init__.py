"""Evaluation runners (counterpart of ``pips_tpu/evals``): FlyingThings++,
BADJA, CroHD and the DAVIS dense-grid throughput probe, each a module with
``main`` and a CLI (``python -m pips_tpu_torch.evals.run_flt ...``), and the
reference's metrics."""

from pips_tpu_torch.evals.metrics import ate_metrics, pck_at_sqrt_area, per_seq_vis_label

__all__ = ["ate_metrics", "pck_at_sqrt_area", "per_seq_vis_label"]
