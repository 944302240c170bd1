"""Tensor ops (counterpart of ``pips_tpu/ops``)."""

from pips_tpu_torch.ops.corr import build_fmap_pyramid, corr_pyramid, sample_corr_pyramid
from pips_tpu_torch.ops.embed import get_3d_embedding
from pips_tpu_torch.ops.grids import gridcloud2d, meshgrid2d
from pips_tpu_torch.ops.resize import avg_pool2x2, resize_bilinear_align_corners
from pips_tpu_torch.ops.samp import bilinear_sample2d, grid_sample_zeros

__all__ = ["avg_pool2x2", "bilinear_sample2d", "build_fmap_pyramid", "corr_pyramid",
           "get_3d_embedding", "grid_sample_zeros", "gridcloud2d", "meshgrid2d",
           "resize_bilinear_align_corners", "sample_corr_pyramid"]
