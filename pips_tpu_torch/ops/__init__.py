"""Tensor ops (counterpart of ``pips_tpu/ops``)."""

from pips_tpu_torch.ops.corr import (build_fmap_pyramid, corr_pyramid, fcp_from_fused,
                                     fcp_score_maps, fused_corr_sample, fused_pyramid_fmap,
                                     sample_corr_pyramid)
from pips_tpu_torch.ops.embed import get_3d_embedding, posemb_sincos_2d_xy, posemb_sincos_3d
from pips_tpu_torch.ops.fps import farthest_point_sample, farthest_point_sample_py
from pips_tpu_torch.ops.grids import coords_grid, gridcloud2d, meshgrid2d
from pips_tpu_torch.ops.reduce import normalize, reduce_masked_mean
from pips_tpu_torch.ops.resize import avg_pool2x2, resize_bilinear_align_corners
from pips_tpu_torch.ops.samp import bilinear_sample2d, grid_sample_zeros

__all__ = ["avg_pool2x2", "bilinear_sample2d", "build_fmap_pyramid", "coords_grid",
           "corr_pyramid", "farthest_point_sample", "farthest_point_sample_py",
           "fcp_from_fused", "fcp_score_maps", "fused_corr_sample",
           "fused_pyramid_fmap", "get_3d_embedding", "grid_sample_zeros", "gridcloud2d",
           "meshgrid2d", "normalize", "posemb_sincos_2d_xy", "posemb_sincos_3d",
           "reduce_masked_mean", "resize_bilinear_align_corners",
           "sample_corr_pyramid"]
