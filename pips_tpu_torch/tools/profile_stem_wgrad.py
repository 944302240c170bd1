"""The stem conv's weight gradient: the kernel against the library's, on the card.

Counterpart of ``tools/profile_stem_wgrad.py``. For the stem's W-s2d conv
(stride (2, 1), VALID, 7x4 taps, 6 -> 64 channels) at B=1 and B=8, 384x512,
bf16 (or f32: ``--dtype float32``), it prints dk's max|err| of
``kernels.stem_wgrad_cuda.stem_wgrad`` (``pips_tpu_torch/csrc/stem_wgrad.cu``)
against the library's autograd, and the row-tap (x7) form's difference from
the conv; then times, forward and forward+dk, in turns: "library"
(``F.conv2d`` with autograd), "kernel" (``stem_conv_s2d``: the library
forward, the kernel's weight gradient) and "x7" (the row taps folded into 42
channels, a stride-1 (1, 4)-tap conv). Timing:
``profile_block_kernel.in_turns``: CUDA events around ``reps`` calls (a
synchronised host clock on the CPU), the median over ``rounds``, the three
in turns.

    python3 -m pips_tpu_torch.tools.profile_stem_wgrad [--dtype float32]

``--wgrad`` times the weight gradient alone instead, at B=1 and B=8,
384x512 and at the smoke's small 2x64x96: ``stem_wgrad`` held to its plain
version (within 4 u K m, as smoke phase 3f) and against itself (two calls,
the same bits), then timed in turns with ``torch.nn.grad.conv2d_weight``
(TF32 off), beside its plain version and its bound (2*168*64 FLOP a pixel at
the dtype's peak, or x2, dy and dk once at 3.35 TB/s).

    python3 -m pips_tpu_torch.tools.profile_stem_wgrad --wgrad --dtype float32 [--against DIR]

``--against DIR`` runs that in another checkout too (DIR holds its
``pips_tpu_torch``: a ``git archive`` of another commit, say), in four
processes in turns (DIR, this, this, DIR), each building its own kernels,
and prints the two side by side. The last line is one JSON object.

Runs on CUDA; ``run(..., device="cpu")`` runs the plain weight gradient
instead (tests).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels.stem_wgrad_cuda import (stem_conv_s2d, stem_wgrad,
                                                    stem_wgrad_reference)
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools.profile_block_kernel import in_turns
from pips_tpu_torch.tools.profile_conv_f32 import median_ms

ROUNDS, REPS = 5, 10
SHAPES = ((1, 384, 512), (8, 384, 512))
# --wgrad: the tool's shapes and smoke phase 3f's small one (x2 (2, 6, 70, 51))
WGRAD_SHAPES = (("B=1", 1, 384, 512), ("B=8", 8, 384, 512), ("small", 2, 64, 96))
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM: f32 FMA, bf16 tensor cores
PEAK_BYTES = 3.35e12
U32 = 2.0 ** -24


def tag(B: int, H: int, W: int, dtype) -> str:
    return f"B={B} {H}x{W} {'bf16' if dtype == torch.bfloat16 else 'f32'}"


def conv(x2, k2):
    return F.conv2d(x2, k2, stride=(2, 1))


def conv_x7(x2, k2):
    """Row-tap unfold: x7[b, ky*C + c, h, w'] = x2[b, c, 2h + ky, w'], then a
    stride-1 (1, 4)-tap conv with 7C = 42 input channels."""
    O, C, KY, KX = k2.shape
    Ho = (x2.shape[2] - KY) // 2 + 1
    x7 = torch.cat([x2[:, :, ky:ky + 2 * Ho - 1:2] for ky in range(KY)], dim=1)
    k7 = k2.permute(0, 2, 1, 3).reshape(O, KY * C, 1, KX)  # k7[o, ky*C + c, 0, kx]
    return F.conv2d(x7, k7)


def kernel_launches(rounds: int = ROUNDS, reps: int = REPS) -> int:
    """``stem_wgrad`` kernel calls of one ``run`` on CUDA at a tileable
    shape: the error check, then one per forward+dk of "kernel", one warm-up."""
    return 1 + 1 + rounds * reps


def run(B: int, H: int, W: int, dtype=torch.bfloat16, tag: str = "", device: str = "cuda",
        rounds: int = ROUNDS, reps: int = REPS) -> dict:
    device = resolve_device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    C, O = 6, 64
    Ho, Wo = H // 2, W // 2
    Hp, Wp = 2 * Ho + 6, Wo + 3
    rng = np.random.RandomState(0)
    # the JAX tool's draws, NHWC/HWIO, then the port's layouts: channels_last
    # activations (NHWC in memory) and an (O, C, KY, KX) weight
    x2 = torch.from_numpy(rng.rand(B, Hp, Wp, C) - 0.5).to(device, dtype).permute(0, 3, 1, 2)
    k2 = torch.from_numpy(rng.rand(7, 4, C, O) * 0.1 - 0.05).to(device, dtype)
    k2 = k2.permute(3, 2, 0, 1).contiguous()
    dy = torch.from_numpy(rng.rand(B, Ho, Wo, O) - 0.5).to(device, dtype).permute(0, 3, 1, 2)

    # numerics: the kernel's dk against the library's autograd (both f32-accumulated)
    kr = k2.clone().requires_grad_(True)
    (conv(x2, kr).float() * dy.float()).sum().backward()
    dk_ref = kr.grad.float()
    dk = stem_wgrad(x2, dy)
    err = (dk - dk_ref).abs().max().item()
    scale = dk_ref.abs().max().item() + 1e-9
    print(f"{tag}: dk max|err|={err:.4f} rel={err / scale:.2e}", flush=True)
    with torch.no_grad():
        d7 = (conv_x7(x2, k2).float() - conv(x2, k2).float()).abs().max().item()
    print(f"{tag} conv_x7 max|diff| vs conv: {d7:.5f}", flush=True)

    impls = {"library": conv, "kernel": stem_conv_s2d, "x7": conv_x7}

    def fwd(f):  # a step of in_turns' chain: x2 passes through unchanged
        def step(x):
            with torch.no_grad():
                f(x, k2)
            return x
        return step

    def fwd_dk(f):
        def step(x):
            k = k2.detach().requires_grad_(True)
            (f(x, k).float().square().sum() * 1e-6).backward()
            return x
        return step

    out = {"err": err, "rel": err / scale, "x7_diff": d7}
    for mode, mk in (("fwd", fwd), ("fwd+dk", fwd_dk)):
        times = in_turns({name: mk(f) for name, f in impls.items()}, x2, rounds, reps)
        for name, ms in times.items():
            out[f"{mode} {name}"] = ms
            print(f"{tag} {name:8s}{mode:7s}: {ms * 1e3:.0f} us", flush=True)
    return out


def main(device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS,
         dtype: str = "bfloat16") -> dict:
    dt = getattr(torch, dtype)
    return {tag(B, H, W, dt): run(B, H, W, dt, tag(B, H, W, dt), device, rounds, reps)
            for B, H, W in SHAPES}


def bound(B: int, Ho: int, Wo: int, dtype: str) -> float:
    """Least ms for the weight gradient: its operations at the dtype's peak,
    or x2 (B, 2*Ho + 6, Wo + 3, 6) and dy read once and dk written once."""
    size = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * 168 * 64 * B * Ho * Wo
    nbytes = size * B * ((2 * Ho + 6) * (Wo + 3) * 6 + Ho * Wo * 64) + 4 * 168 * 64
    return max(flops / PEAK[dtype], nbytes / PEAK_BYTES) * 1e3


def wgrad(B: int, H: int, W: int, dtype: str = "float32") -> dict:
    """``stem_wgrad`` alone on the card: checked, then timed in turns with
    ``conv2d_weight`` (kernel, library, kernel, library), beside its plain
    version and its bound. Inputs as smoke phase 3f draws them."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: --wgrad times the kernel on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Ho, Wo = H // 2, W // 2
    rng = np.random.RandomState(B + H)
    x2, dy = (torch.from_numpy((rng.rand(*shape) - 0.5).astype(np.float32))
              .to("cuda", getattr(torch, dtype)).permute(0, 3, 1, 2)
              for shape in ((B, 2 * Ho + 6, Wo + 3, 6), (B, Ho, Wo, 64)))
    dk, again = stem_wgrad(x2, dy), stem_wgrad(x2, dy)
    err = (dk - stem_wgrad_reference(x2, dy)).abs().max().item()
    tol = 4 * U32 * B * Ho * Wo * 0.25  # |x2|, |dy| <= 0.5
    if not (torch.equal(dk, again) and err <= tol):
        raise RuntimeError(f"stem_wgrad {dtype} B={B} {H}x{W}: max_abs_err {err} (tol {tol}), "
                           f"repeat equal {torch.equal(dk, again)}")

    def library():
        return torch.nn.grad.conv2d_weight(x2, (64, 6, 7, 4), dy, stride=(2, 1))

    times = {"kernel": [], "library": []}
    for _ in range(2):
        times["kernel"].append(median_ms(torch, lambda: stem_wgrad(x2, dy)))
        times["library"].append(median_ms(torch, library))
    plain = median_ms(torch, lambda: stem_wgrad_reference(x2, dy), launches=3)
    return dict(ms=times["kernel"], library_ms=times["library"], plain_ms=plain,
                bound_ms=bound(B, Ho, Wo, dtype), max_abs_err=err)


def wgrad_all(dtype: str) -> dict:
    return {f"{case} {dtype}": wgrad(B, H, W, dtype) for case, B, H, W in WGRAD_SHAPES}


def show(label: str, res: dict) -> None:
    for case, r in res.items():
        ms = sum(r["ms"]) / len(r["ms"])
        print(f"{label}: {case}: {'/'.join(f'{v:.4f}' for v in r['ms'])} ms, conv2d_weight "
              f"{'/'.join(f'{v:.4f}' for v in r['library_ms'])} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({ms / r['bound_ms']:.2f}x), max_abs_err "
              f"{r['max_abs_err']:.3g}", flush=True)


def against(other: Path, dtype: str) -> dict:
    """``--wgrad`` in the checkout ``other`` and in this one, in four
    processes in turns (other, this, this, other): each case's two times of
    each side."""
    here = Path(__file__).resolve().parents[2]
    runs = {"other": [], "this": []}
    for side, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(tree)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--wgrad",
                               "--dtype", dtype, "--tree"], cwd=tree, env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"profile_stem_wgrad in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        show(f"{side} ({tree})", res)
        runs[side].append(res)
    return {case: {"other_ms": [v for r in runs["other"] for v in r[case]["ms"]],
                   "this_ms": [v for r in runs["this"] for v in r[case]["ms"]],
                   "library_ms": [v for r in runs["other"] + runs["this"]
                                  for v in r[case]["library_ms"]],
                   "plain_ms": runs["this"][0][case]["plain_ms"],
                   "bound_ms": runs["this"][0][case]["bound_ms"]}
            for case in runs["this"][0] if case in runs["other"][0]}


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--wgrad", action="store_true",
                    help="time the weight gradient alone, in turns with conv2d_weight")
    ap.add_argument("--against", type=Path, default=None,
                    help="with --wgrad: another checkout whose kernel to time in turns with this")
    ap.add_argument("--tree", action="store_true",
                    help="print only the JSON line (the processes of --against)")
    args = ap.parse_args(argv)
    if not args.wgrad:
        return main(dtype=args.dtype)
    if args.against is not None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        res = against(args.against.resolve(), args.dtype)
        for case, r in res.items():
            print(f"{case}: {'/'.join(f'{v:.4f}' for v in r['other_ms'])} -> "
                  f"{'/'.join(f'{v:.4f}' for v in r['this_ms'])} ms, conv2d_weight "
                  f"{'/'.join(f'{v:.4f}' for v in r['library_ms'])}, plain {r['plain_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f}", flush=True)
    else:
        res = wgrad_all(args.dtype)
        if not args.tree:
            show("kernel", res)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    cli()
