"""What the three probe tools share: each probe's kernel held against its
plain version with the probe's tolerance, then all of them timed in turns.

A probe with a bf16 output is held elementwise to one bf16 ulp of the larger
magnitude: the kernel computes in f32 and the plain version in f32 or f64,
and each rounds once. Where the kernel's formula cancels in f32 before that
rounding, the probe adds the slack that the cancellation allows (GELU's left
tail: ``GELU_SLACK``). A probe with an f32 output gives ``terms``, the sum
of |term| behind each output (its plain version on the operands'
magnitudes), and is held to ``F32_SUM_TOL`` of it: bf16 products are exact
in f32, so only the order of the f32 sums differs. Nothing is caught: a miss raises, as a build or launch error does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pips_tpu_torch.tools.profile_block_kernel import in_turns

F32_SUM_TOL = 1e-5
# 0.5 x (1 + erf(x / sqrt 2)) cancels in f32 for x << 0, where erf is near -1,
# so an erf off by e moves it by 0.5 |x| e. The plain version is f64 (no
# error of its own); the kernel's erff is within 2 f32 ulps (2^-24 each near
# 1: CUDA's documented bound) and its argument x * f32(1/sqrt 2) within one
# more: 0.5 |x| 3 2^-24, held to |x| 2^-23
GELU_SLACK = 2.0 ** -23


@dataclasses.dataclass
class Probe:
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    terms: Optional[Callable[[], torch.Tensor]] = None  # None: a bf16 output
    slack: Optional[Callable[[], torch.Tensor]] = None  # a bf16 output's absolute slack


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits): 2^(e - 8) for |v| = m 2^e,
    m in [0.5, 1)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check(name: str, got: torch.Tensor, want: torch.Tensor, terms: Optional[torch.Tensor],
          slack: Optional[torch.Tensor] = None) -> tuple[float, float]:
    """max |got - want| and the worst err/tol; raises where a value misses."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype}, plain version "
                           f"{tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs()
    if terms is None:
        tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        if slack is not None:
            tol = tol + slack
    else:
        tol = F32_SUM_TOL * terms.float()
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / tol)
    worst = ratio.max().item() if ratio.numel() else 0.0
    if not worst <= 1.0:  # NaN fails too
        raise RuntimeError(f"{name}: FAIL, max|err|={diff.max().item():.4g} is beyond the "
                           f"tolerance (worst err/tol {worst:.4g})")
    return (diff.max().item() if diff.numel() else 0.0), worst


def run(probes: dict[str, Probe], rounds: int, reps: int) -> dict:
    """Check every probe, then time their kernels in turns (``in_turns``: CUDA
    events around ``reps`` calls, the median of ``rounds``; a host launch
    slower than its kernel is what such a time measures). Prints a line per
    probe and returns its sum (f32, as the JAX tools print it), max|err|,
    worst err/tol and ms per call."""
    out, x0 = {}, None
    for name, p in probes.items():
        got = p.kernel()
        err, worst = check(name, got, p.plain(), None if p.terms is None else p.terms(),
                           None if p.slack is None else p.slack())
        out[name] = {"sum": got.float().sum().item(), "max_abs_err": err, "err_over_tol": worst}
        x0 = got
    steps = {name: (lambda x, f=p.kernel: (f(), x)[1]) for name, p in probes.items()}
    for name, ms in in_turns(steps, x0, rounds, reps).items():
        r = out[name]
        r["ms"] = ms
        print(f"{name}: OK sum={r['sum']:.4f} max|err|={r['max_abs_err']:.4g} (err/tol "
              f"{r['err_over_tol']:.3g}) {ms * 1e3:.2f} us/call", flush=True)
    return out
