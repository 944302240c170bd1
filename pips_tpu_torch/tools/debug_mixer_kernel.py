"""The Mosaic probes of a fused mixer-block kernel, as CUDA kernels on the card.

Counterpart of ``tools/debug_mixer_kernel.py``, which checked that Mosaic
lowers exact-erf GELU, the f32 LayerNorm of a static 512-lane slice of a
(128, 8 * 512) tile, and weights streamed over a grid of 12 blocks into one
f32 accumulator. Here those are ``kernels/mixer_probes_cuda.py``'s ``gelu``,
``ln_slice`` and ``stream_accum`` (``pips_tpu_torch/csrc/mixer_probes.cu``),
run on the JAX tool's inputs (``inputs``: drawn from
``np.random.RandomState(0)`` in its order). Each probe's output is held to its
plain version (``tools/_probes.py`` says with what tolerance), then the three
are timed in turns; a line per probe gives the JAX tool's name, the sum it
prints, max|err| and the time. A build, launch or tolerance failure raises.

    python3 -m pips_tpu_torch.tools.debug_mixer_kernel

Runs on CUDA; ``main(device="cpu")`` runs the plain versions instead (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from pips_tpu_torch.kernels.mixer_probes_cuda import (gelu, gelu_reference, ln_slice,
                                                      ln_slice_reference, stream_accum,
                                                      stream_accum_reference)
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools import _probes

TN, S, D, F = 128, 8, 512, 2048
BLOCKS = 12  # weight blocks of w1, the probe's grid
ROUNDS, REPS = 5, 10
KERNELS = {"erf": "gelu", "ln_slice": "ln_slice", "block_stream_accum": "stream_accum"}


def inputs(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's x (128, 4096) and w1 (12, 512, 2048), bf16."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(TN, S * D)).to(torch.bfloat16)
    w1 = torch.from_numpy(rng.randn(BLOCKS, D, F) * 0.02).to(torch.bfloat16)
    return x.to(device), w1.to(device)


def probes(x: torch.Tensor, w1: torch.Tensor) -> dict[str, _probes.Probe]:
    return {"erf": _probes.Probe(lambda: gelu(x), lambda: gelu_reference(x),
                                 slack=lambda: _probes.GELU_SLACK * x.float().abs()),
            "ln_slice": _probes.Probe(lambda: ln_slice(x, D), lambda: ln_slice_reference(x, D)),
            "block_stream_accum": _probes.Probe(
                lambda: stream_accum(x, w1), lambda: stream_accum_reference(x, w1),
                lambda: stream_accum_reference(x.abs(), w1.abs()))}


def kernel_launches(rounds: int = ROUNDS, reps: int = REPS) -> dict[str, int]:
    """Launches of each kernel in one ``main`` on CUDA: the check, one
    warm-up and ``rounds * reps`` timed calls."""
    return {k: 2 + rounds * reps for k in KERNELS.values()}


def main(device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS) -> dict:
    return _probes.run(probes(*inputs(device)), rounds, reps)


if __name__ == "__main__":
    main()
