"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Counterpart of ``pips_tpu/kernels``; ``_build`` compiles ``csrc/*.cu`` at
first use.
"""

from pips_tpu_torch.kernels.corr_cuda import corr_sample, corr_sample_reference
from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.kernels.mixer_cuda import (chan_ff_block, chan_ff_bwd, chan_ff_bwd_reference,
                                               chan_ff_reference)

__all__ = ["chan_ff_block", "chan_ff_bwd", "chan_ff_bwd_reference", "chan_ff_reference",
           "corr_sample", "corr_sample_reference", "sample_corr_onehot"]
