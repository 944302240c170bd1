"""ctypes bindings for the port's host data-plane library (counterpart of
``pips_tpu/native``): ``pips_host.cpp`` beside ``lib.py``, built at first use
into ``build/``. A failed build raises; the numpy forms (``*_reference``) are
the plain versions that the tests and the chip smoke hold each entry against.
"""

from pips_tpu_torch.native.lib import (available, chain_step, color_affine, composite,
                                       decode_pfm, decode_pfm_file, ensure_built,
                                       gaussian_blur, hue_shift, mark_covered_frame,
                                       mark_in_rects, resize_bilinear, visibility_frame)

__all__ = ["available", "chain_step", "color_affine", "composite", "decode_pfm",
           "decode_pfm_file", "ensure_built", "gaussian_blur", "hue_shift",
           "mark_covered_frame", "mark_in_rects", "resize_bilinear", "visibility_frame"]
