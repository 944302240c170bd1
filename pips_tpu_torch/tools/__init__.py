"""Profiling and probe tools of the port, each named after its JAX
counterpart under ``tools/``: ``profile_block_kernel`` (the fused stage-1
residual block), ``profile_stem_wgrad`` (the stem conv's weight gradient),
``profile_chanff_chunk`` (the F-chunked channel block against the monolithic
one), and the Mosaic probes ``debug_mixer_kernel`` (erf GELU, a lane-slice
LayerNorm, a streamed-weight product), ``debug_pallas7`` (the row-wise corr
patch) and ``probe_mosaic_ops`` (row contractions in four layouts), each
probe a CUDA kernel held to its plain version. Run on the card:

    python3 -m pips_tpu_torch.tools.profile_block_kernel
    python3 -m pips_tpu_torch.tools.profile_stem_wgrad
    python3 -m pips_tpu_torch.tools.profile_chanff_chunk 512 1024
    python3 -m pips_tpu_torch.tools.debug_mixer_kernel
    python3 -m pips_tpu_torch.tools.debug_pallas7
    python3 -m pips_tpu_torch.tools.probe_mosaic_ops
"""
