"""Profiling tools of the port, each named after its JAX counterpart under
``tools/``: ``profile_block_kernel`` (the fused stage-1 residual block),
``profile_stem_wgrad`` (the stem conv's weight gradient) and
``profile_chanff_chunk`` (the F-chunked channel block against the monolithic
one). Run on the card:

    python3 -m pips_tpu_torch.tools.profile_block_kernel
    python3 -m pips_tpu_torch.tools.profile_stem_wgrad
    python3 -m pips_tpu_torch.tools.profile_chanff_chunk 512 1024
"""
