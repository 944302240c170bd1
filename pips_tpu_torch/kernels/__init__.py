"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Counterpart of ``pips_tpu/kernels``; ``_build`` compiles ``csrc/*.cu`` at
first use.
"""

from pips_tpu_torch.kernels.block_cuda import (conv_pass, conv_pass_reference, res_block64,
                                               res_block64_reference)
from pips_tpu_torch.kernels.chanff_chunk_cuda import (chan_ff_block_chunked,
                                                      chan_ff_chunked_bwd_reference,
                                                      chan_ff_chunked_reference)
from pips_tpu_torch.kernels.conv_cuda import conv3x3_reference, conv3x3_same
from pips_tpu_torch.kernels.corr_cuda import corr_sample, corr_sample_reference
from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.kernels.corr_rows_cuda import corr_rows, corr_rows_reference
from pips_tpu_torch.kernels.mixer_cuda import (chan_ff_block, chan_ff_bwd, chan_ff_bwd_reference,
                                               chan_ff_reference)
from pips_tpu_torch.kernels.mixer_probes_cuda import (gelu, gelu_reference, ln_slice,
                                                      ln_slice_reference, stream_accum,
                                                      stream_accum_reference)
from pips_tpu_torch.kernels.row_contract_cuda import row_contract, row_contract_reference
from pips_tpu_torch.kernels.stem_wgrad_cuda import (stem_conv_s2d, stem_wgrad,
                                                    stem_wgrad_reference, stem_wgrad_supported)
from pips_tpu_torch.kernels.token_cuda import token_mix_block, token_mix_reference

__all__ = ["chan_ff_block", "chan_ff_block_chunked", "chan_ff_bwd", "chan_ff_bwd_reference",
           "chan_ff_chunked_bwd_reference", "chan_ff_chunked_reference", "chan_ff_reference",
           "conv3x3_reference", "conv3x3_same", "conv_pass", "conv_pass_reference",
           "corr_rows", "corr_rows_reference", "corr_sample", "corr_sample_reference", "gelu",
           "gelu_reference", "ln_slice", "ln_slice_reference", "res_block64",
           "res_block64_reference", "row_contract", "row_contract_reference",
           "sample_corr_onehot", "stem_conv_s2d", "stem_wgrad", "stem_wgrad_reference",
           "stem_wgrad_supported", "stream_accum", "stream_accum_reference", "token_mix_block",
           "token_mix_reference"]
