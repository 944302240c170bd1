"""The stem-wgrad design's Mosaic probes as one CUDA kernel on the card.

Counterpart of ``tools/probe_mosaic_ops.py``, which checked three Mosaic
lowerings on (24, 256, 6) x (24, 256, 64) bf16 operands: A, a dot_general
with two contracting dims -> (6, 64); A2, both operands collapsed to 2-D in
the kernel first; B, a minor-dim split reshape of a folded a; and C, 28
(24, 6) tiles concatenated along lanes against b[:, 0] -> (168, 64). Each is
``kernels/row_contract_cuda.py:row_contract``
(``pips_tpu_torch/csrc/row_contract.cu``) on views of the same bytes: A, A2
and B are one layout on the card, C a strided batch. They run on the JAX
tool's inputs (``inputs``: a0, b0 = rand - 0.5 from
``np.random.RandomState(0)``), are held to their plain versions
(``tools/_probes.py`` says with what tolerance) and timed in turns; a line
per probe gives the JAX tool's name, the output's sum, max|err| and the
time. A build, launch or tolerance failure raises.

    python3 -m pips_tpu_torch.tools.probe_mosaic_ops

Runs on CUDA; ``main(device="cpu")`` runs the plain versions instead (tests).
"""

from __future__ import annotations

import numpy as np
import torch

from pips_tpu_torch.kernels.row_contract_cuda import row_contract, row_contract_reference
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools import _probes

TH, Wo, C, O = 24, 256, 6, 64
TILES = 28  # probe C's lane-concatenated tiles
ROUNDS, REPS = 5, 10
KERNELS = {"A dot2contract": "A", "A2 collapse3d->2d": "A2", "B minorsplit": "B",
           "C laneconcat": "C"}


def inputs(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's a0 (24, 256, 6) and b0 (24, 256, 64), bf16."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    a0 = torch.from_numpy(rng.rand(TH, Wo, C) - 0.5).to(torch.bfloat16)
    b0 = torch.from_numpy(rng.rand(TH, Wo, O) - 0.5).to(torch.bfloat16)
    return a0.to(device), b0.to(device)


def _contract(a, b, probe: str, plain: bool):
    return row_contract_reference(a, b) if plain else row_contract(a, b, probe=probe)


def probe_a(a, b, plain: bool = False):
    """A: contract (TH, Wo, C) with (TH, Wo, O) over both leading dims -> (C, O)."""
    return _contract(a.reshape(1, TH * Wo, C), b.reshape(1, TH * Wo, O), "A", plain)[0]


def probe_a2(a, b, plain: bool = False):
    """A2: both operands collapsed to (TH * Wo, .) first: the same bytes."""
    a2, b2 = a.reshape(TH * Wo, C), b.reshape(TH * Wo, O)
    return _contract(a2[None], b2[None], "A2", plain)[0]


def probe_b(a, b, plain: bool = False):
    """B: a folded to (TH, Wo * C) and split back to (TH * Wo, C) in the kernel."""
    a_fold, b_fold = a.reshape(TH, Wo * C), b.reshape(TH * Wo, O)
    return _contract(a_fold.reshape(TH * Wo, C)[None], b_fold[None], "B", plain)[0]


def probe_c(a, b, plain: bool = False):
    """C: row block i of 6 is a[:, i, :]^T b[:, 0, :] for i < 28 -> (168, O):
    28 batches of TH rows, a's batch stride one pixel, b's zero."""
    tiles = a[:, :TILES].transpose(0, 1)  # (28, TH, C); JAX's i % Wo is i here
    rows = b[:, 0][None].expand(TILES, TH, O)
    return _contract(tiles, rows, "C", plain).reshape(TILES * C, O)


def probes(a: torch.Tensor, b: torch.Tensor) -> dict[str, _probes.Probe]:
    fns = dict(zip(KERNELS, (probe_a, probe_a2, probe_b, probe_c)))
    return {name: _probes.Probe(lambda f=f: f(a, b), lambda f=f: f(a, b, plain=True),
                                lambda f=f: f(a.abs(), b.abs(), plain=True))
            for name, f in fns.items()}


def kernel_launches(rounds: int = ROUNDS, reps: int = REPS) -> dict[str, int]:
    """Launches under each probe's name in one ``main`` on CUDA: the check,
    one warm-up and ``rounds * reps`` timed calls."""
    return {k: 2 + rounds * reps for k in KERNELS.values()}


def main(device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS) -> dict:
    return _probes.run(probes(*inputs(device)), rounds, reps)


if __name__ == "__main__":
    main()
