"""F-chunked channel blocks against the monolithic ones, on the card.

Counterpart of ``tools/profile_chanff_chunk.py``. Times a chain of 12 channel
blocks at D=512, F=2048 on bf16 rows (R=1024 by default), with the JAX tool's
12 f32 weight sets drawn from ``np.random.RandomState(0)`` and the rows after
them:
  * base: ``kernels.mixer_cuda.chan_ff_block`` (``csrc/chanff_fwd.cu`` and
    ``chanff_bwd.cu``: tiled products on 128 x 128 tiles, the activation
    written to device memory between them);
  * chunk, at each width fc: ``kernels.chanff_chunk_cuda.chan_ff_block_chunked``
    (``csrc/chanff_chunk.cu``: one fused chunk pipeline a call, 64-row tiles
    whose F runs of whole chunks are a cluster's blocks, the activation kept
    in shared memory slab by slab between its two products).

First each chunked chain's output against the base chain's (max |diff|), then
the forward and the forward+backward (the grads of all 72 weight tensors, as
the JAX tool's ``value_and_grad`` takes them) of each, printed in us per
chain and TF/s with the JAX tool's operation count,
12 * (7 if backward else 2) * 2 * R * D * F. Timing: CUDA events around
``reps`` chains in a row, each on the previous chain's output (a synchronised
host clock on the CPU), the median over ``rounds`` with the variants in turns.

    python3 -m pips_tpu_torch.tools.profile_chanff_chunk [FC ...] [--R 1024]

Runs on CUDA; ``main(device="cpu")`` runs the plain versions instead (tests).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from pips_tpu_torch.kernels.chanff_chunk_cuda import chan_ff_block_chunked
from pips_tpu_torch.kernels.mixer_cuda import chan_ff_block
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools.profile_block_kernel import in_turns

D, F, DEPTH = 512, 2048, 12
ROUNDS, REPS = 5, 10


def weights(rng: np.random.RandomState, device) -> list[tuple[torch.Tensor, ...]]:
    """The JAX tool's ``WS``: per block (ln_scale, ln_bias, w1, b1, w2, b2), f32."""
    return [tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        1 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), rng.randn(D, F) * 0.03,
        0.1 * rng.randn(F), rng.randn(F, D) * 0.03, 0.1 * rng.randn(D)))
        for _ in range(DEPTH)]


def kernel_launches(fcs=(512, 1024), rounds: int = ROUNDS, reps: int = REPS) -> tuple[int, int]:
    """Chunked forward and backward launches of one ``main`` on CUDA: per
    width, the parity chain, then one warm-up and ``rounds * reps`` chains
    forward and forward+backward, 12 blocks each."""
    chains = 1 + rounds * reps
    return len(fcs) * DEPTH * (1 + 2 * chains), len(fcs) * DEPTH * chains


def main(fcs=(512, 1024), R: int = 1024, device: str = "cuda", rounds: int = ROUNDS,
         reps: int = REPS) -> dict:
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    ws = weights(rng, device)
    x0 = torch.from_numpy(rng.randn(R, D).astype(np.float32)).to(device, torch.bfloat16)
    blocks = {"base": chan_ff_block}
    blocks.update({fc: functools.partial(chan_ff_block_chunked, fc=fc) for fc in fcs})
    leaves = [t.clone().requires_grad_(True) for w in ws for t in w]
    wg = [leaves[i:i + 6] for i in range(0, len(leaves), 6)]

    def fwd(block):
        def step(x):
            with torch.no_grad():
                for w in ws:
                    x = block(x, *w)
            return x
        return step

    def fwd_bwd(block):
        def step(x):
            y = x
            for w in wg:
                y = block(y, *w)
            torch.autograd.grad(y.float().sum(), leaves)
            return y.detach()
        return step

    base_y = fwd(blocks["base"])(x0).float()
    parity = {}
    for fc in fcs:
        parity[fc] = (fwd(blocks[fc])(x0).float() - base_y).abs().max().item()
        print(f"chunk fc={fc:4d} R={R}: chain output max|diff| vs base = {parity[fc]:.4f} "
              f"(|y| <= {base_y.abs().max().item():.3g})", flush=True)

    out = {"R": R, "parity": parity, "y_absmax": base_y.abs().max().item()}
    for bwd, mk in ((False, fwd), (True, fwd_bwd)):
        t = in_turns({name: mk(b) for name, b in blocks.items()}, x0, rounds, reps)
        flops = DEPTH * (7 if bwd else 2) * 2 * R * D * F
        for name, ms in t.items():
            tag, fc = ("base", 512) if name == "base" else ("chunk", name)
            print(f"{tag:6s} fc={fc:4d} R={R} {'fwd+bwd' if bwd else 'fwd':7s}:"
                  f" {ms * 1e3:7.0f} us ({flops / (ms / 1e3) / 1e12:5.1f} TF/s)", flush=True)
        out["fwd+bwd" if bwd else "fwd"] = {name: ms / 1e3 for name, ms in t.items()}
    return out  # seconds per chain of 12 blocks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fcs", type=int, nargs="*", default=[512, 1024], help="chunk widths")
    ap.add_argument("--R", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--reps", type=int, default=REPS)
    a = ap.parse_args()
    main(tuple(a.fcs or (512, 1024)), R=a.R, rounds=a.rounds, reps=a.reps)
