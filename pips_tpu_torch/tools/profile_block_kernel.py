"""The fused stage-1 residual block against the modular one, on the card.

Counterpart of ``tools/profile_block_kernel.py``. Compares, at the stage-1
bench shape (8 frames, 192x256, 64 channels, bf16):
  * library: the port's ``models.encoder.ResidualBlock(64, 64, 1)``, cuDNN's
    convs and ``instance_norm`` under autograd (where the JAX tool runs its
    s2d ``ResidualBlock`` under XLA);
  * kernel: ``kernels.block_cuda.res_block64``, one autograd Function per
    block, the instance-norm statistics from the conv kernel's epilogue and
    the first norm in the second pass's prologue
    (``pips_tpu_torch/csrc/conv3x3_stats.cu``).

It prints the forward parity max|diff|, then the forward time and the
forward+backward time (grads of x, w1 and w2) of each, with the same logical
FLOP counts as the JAX tool. Timing: a chain in which each call consumes the
previous output, CUDA events around ``reps`` calls (a synchronised host clock
on the CPU), the median over ``rounds`` with the two run in turns.

    python3 -m pips_tpu_torch.tools.profile_block_kernel [--B 8 --H 192 --W 256 --dtype bfloat16]

Runs on CUDA; ``main(device="cpu")`` runs the plain conv pass instead (tests).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pips_tpu_torch.kernels.block_cuda import res_block64
from pips_tpu_torch.models.encoder import ResidualBlock
from pips_tpu_torch.models.pips import resolve_device

ROUNDS, REPS = 5, 10


def chain_ms(step, x0: torch.Tensor, reps: int) -> float:
    """Per-call ms of ``reps`` calls in a row, each on the previous output."""
    x = x0
    if x0.is_cuda:
        torch.cuda.synchronize(x0.device)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            x = step(x)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        x = step(x)
    return (time.perf_counter() - t) * 1e3 / reps


def in_turns(steps: dict, x0: torch.Tensor, rounds: int, reps: int) -> dict:
    """Median per-call ms of each step over ``rounds``, the steps in turns,
    after one warm-up call each."""
    for step in steps.values():
        chain_ms(step, x0, 1)
    times = {name: [] for name in steps}
    for _ in range(rounds):
        for name, step in steps.items():
            times[name].append(chain_ms(step, x0, reps))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def kernel_launches(rounds: int = ROUNDS, reps: int = REPS) -> int:
    """Conv-pass launches of one ``main`` on CUDA: the parity forward, then
    two per forward and four per forward+backward, one warm-up each."""
    return 2 * (1 + 1 + rounds * reps) + 4 * (1 + rounds * reps)


def main(B: int = 8, H: int = 192, W: int = 256, C: int = 64, dtype: str = "bfloat16",
         device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS) -> dict:
    device = resolve_device(device)
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C)
    w1 = rng.randn(3, 3, C, C) * 0.06
    w2 = rng.randn(3, 3, C, C) * 0.06

    def oihw(w):
        return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).float().to(device)

    # NHWC in memory, (B, C, H, W) by index: torch.channels_last, as the encoder holds it
    x = torch.from_numpy(x).to(device, dt).permute(0, 3, 1, 2)
    w1, w2 = oihw(w1), oihw(w2)
    b1 = torch.zeros(C, device=device)
    b2 = torch.zeros(C, device=device)
    blk = ResidualBlock(C, C, 1, dtype=dt).to(device)
    with torch.no_grad():
        blk.conv1.weight.copy_(w1)
        blk.conv2.weight.copy_(w2)

    def lib_block(xi):
        return blk(xi)

    def krn_block(xi):
        return res_block64(xi, w1, b1, w2, b2)

    with torch.no_grad():
        err = (lib_block(x).float() - krn_block(x).float()).abs().max().item()
    print(f"fwd parity max|diff| = {err:.4f} ({dtype} scale)", flush=True)

    fl_fwd = 2 * (B * H * W * 9 * C * C * 2)  # logical FLOPs of one block forward: 2 convs
    with torch.no_grad():
        t = in_turns({"library": lib_block, "kernel": krn_block}, x, rounds, reps)
    t_x, t_k = t["library"] / 1e3, t["kernel"] / 1e3
    print(f"fwd:      library {t_x * 1e6:7.0f}us ({fl_fwd / t_x / 1e12:5.1f} TF/s logical)"
          f"   kernel {t_k * 1e6:7.0f}us ({fl_fwd / t_k / 1e12:5.1f} TF/s)  "
          f"ratio {t_x / t_k:.2f}x", flush=True)

    # the training backward: grads of x and both conv weights (and the
    # library block's biases, as the JAX tool takes all its params); the next
    # call consumes dx
    w1g, w2g = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)

    def lib_vg(xi):
        xi = xi.detach().requires_grad_(True)
        return torch.autograd.grad(lib_block(xi).float().sum(),
                                   (xi, *blk.parameters()))[0]

    def krn_vg(xi):
        xi = xi.detach().requires_grad_(True)
        return torch.autograd.grad(res_block64(xi, w1g, b1, w2g, b2).float().sum(),
                                   (xi, w1g, w2g))[0]

    t = in_turns({"library": lib_vg, "kernel": krn_vg}, x, rounds, reps)
    t_xg, t_kg = t["library"] / 1e3, t["kernel"] / 1e3
    fl_all = 3 * fl_fwd
    print(f"fwd+bwd:  library {t_xg * 1e6:7.0f}us ({fl_all / t_xg / 1e12:5.1f} TF/s logical)"
          f"   kernel {t_kg * 1e6:7.0f}us ({fl_all / t_kg / 1e12:5.1f} TF/s)  "
          f"ratio {t_xg / t_kg:.2f}x", flush=True)
    # the JAX tool's keys, in seconds; "xla" names the library block
    return {"fwd_xla": t_x, "fwd_kernel": t_k, "bwd_xla": t_xg, "bwd_kernel": t_kg}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, default in (("B", 8), ("H", 192), ("W", 256), ("C", 64)):
        ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    main(**vars(ap.parse_args()))
