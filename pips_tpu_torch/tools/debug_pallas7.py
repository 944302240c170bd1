"""The row-wise corr-patch probe as a CUDA kernel on the card.

Counterpart of ``tools/debug_pallas7.py``, which checked that Mosaic lowers
a 3-D broadcast-multiply and axis reduction: the integer 8x8 corr patch of 8
points on a (16, 128) map of 128 f32 channels, x-major, its first 49 entries
kept. Here that is ``kernels/corr_rows_cuda.py:corr_rows``
(``pips_tpu_torch/csrc/corr_rows.cu``), run on the JAX tool's inputs
(``inputs``: fmap, targets and coords drawn from ``np.random.RandomState(0)``
in its order). The output is held to its plain version (``tools/_probes.py``
says with what tolerance), then timed; the line gives the JAX tool's probe
name, the output's sum, max|err| and the time. A build, launch or tolerance
failure raises.

    python3 -m pips_tpu_torch.tools.debug_pallas7

Runs on CUDA; ``main(device="cpu")`` runs the plain version instead (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from pips_tpu_torch.kernels.corr_rows_cuda import corr_rows, corr_rows_reference
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools import _probes

S, H, W, C, N, r = 1, 16, 128, 128, 8, 3
ROUNDS, REPS = 5, 10
KERNELS = {"rowwise 3d-reduce": "corr_rows"}


def inputs(device="cuda") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX tool's fmap (1, 2048, 128), targets (1, 8, 128) and coords
    (1, 8, 2) xy in [0, 127) x [0, 15), f32."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    fmap = torch.from_numpy(rng.rand(S, H * W, C)).float()
    targets = torch.from_numpy(rng.rand(S, N, C)).float()
    coords = torch.from_numpy(rng.rand(S, N, 2) * [W - 1, H - 1]).float()
    return fmap.to(device), targets.to(device), coords.to(device)


def probes(fmap: torch.Tensor, targets: torch.Tensor,
           coords: torch.Tensor) -> dict[str, _probes.Probe]:
    return {"rowwise 3d-reduce": _probes.Probe(
        lambda: corr_rows(fmap, targets, coords, H, W, r),
        lambda: corr_rows_reference(fmap, targets, coords, H, W, r),
        lambda: corr_rows_reference(fmap.abs(), targets.abs(), coords, H, W, r))}


def kernel_launches(rounds: int = ROUNDS, reps: int = REPS) -> dict[str, int]:
    """Launches of the kernel in one ``main`` on CUDA: the check, one warm-up
    and ``rounds * reps`` timed calls."""
    return {"corr_rows": 2 + rounds * reps}


def main(device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS) -> dict:
    return _probes.run(probes(*inputs(device)), rounds, reps)


if __name__ == "__main__":
    main()
