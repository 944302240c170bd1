"""The f32 3x3 conv kernels at the model's shapes, in turns with cuDNN.

Times ``conv3x3_same`` in f32 (``csrc/conv3x3_fwd.cu``'s ``conv3x3_f32``:
the encoder's four stage-1 convs and their dx under ``--dtype float32
--fuse_conv3 1``) at the stage-1 input of a 480x1024 window (8x64x240x512),
of the training default (32x64x184x248: 4 clips after flips x 8 frames at
368x496) and of the bench train shape (8x64x192x256), and at a small ragged
shape (2x64x31x70); and ``conv_pass`` in f32 (``csrc/conv3x3_stats.cu``'s
``conv3x3_stats_f32``) at the bench and small shapes, prologue on and off.
Each is first held against its plain version (the conv within 1e-4, the
statistics within 1e-5 of their sums of magnitudes), then timed in turns
with ``F.conv2d`` in full f32 (TF32 off), beside its bound: 2*576 FLOP a
(pixel, output) at the H100's 67 TFLOP/s of f32 FMA.

    python3 -m pips_tpu_torch.tools.profile_conv_f32 [--against DIR]

``--against DIR`` times another checkout's kernels (DIR holds its
``pips_tpu_torch``: a ``git archive`` of another commit, say) in turns with
this checkout's, in four processes (DIR, this, this, DIR), each building its
own kernels, and prints the two side by side. CUDA only; the last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("window", 8, 240, 512), ("train default", 32, 184, 248),
          ("bench train", 8, 192, 256), ("small", 2, 31, 70))
PASS_SHAPES = ("bench train", "small")
PEAK_F32 = 67e12  # H100 SXM, f32 FMA (NVIDIA data sheet)
CONV_TOL = 1e-4   # f32 sums of 576 products in another order
STATS_TOL = 1e-5  # of the statistics' sums of magnitudes


def median_ms(torch, fn, launches: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``launches`` calls in
    a row (behind a sleep kernel, so that the host's queueing is not timed),
    divided by ``launches``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return sorted(times)[len(times) // 2]


def run() -> dict:
    """Every case's check and times, {case: {ms, library_ms, bound_ms,
    max_abs_err}}, for the ``pips_tpu_torch`` first on ``sys.path``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pips_tpu_torch.kernels import block_cuda, conv_cuda

    if not torch.cuda.is_available():
        raise SystemExit("profile_conv_f32 needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for case, B, H, W in SHAPES:
        rng = np.random.RandomState(B + H)
        x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).cuda().permute(0, 3, 1, 2)
        w = torch.from_numpy((rng.randn(64, 64, 3, 3) / 24).astype(np.float32)).cuda()
        b = torch.from_numpy((0.1 * rng.randn(64)).astype(np.float32)).cuda()
        err = (conv_cuda.conv3x3_same(x, w, b) - conv_cuda.conv3x3_reference(x, w, b)).abs().max()
        if not err.item() <= CONV_TOL:
            raise RuntimeError(f"conv3x3_f32 {case}: max_abs_err {err.item()} > {CONV_TOL}")
        bound_ms = 2.0 * B * H * W * 64 * 576 / PEAK_F32 * 1e3
        times = {"kernel": [], "library": []}
        for _ in range(2):
            times["kernel"].append(median_ms(torch, lambda: conv_cuda.conv3x3_same(x, w, b)))
            times["library"].append(median_ms(torch, lambda: F.conv2d(x, w, b, padding=1)))
        library_ms = sum(times["library"]) / 2
        out[f"conv3x3_f32 {case}"] = dict(ms=sum(times["kernel"]) / 2, library_ms=library_ms,
                                          bound_ms=bound_ms, max_abs_err=err.item())
        if case in PASS_SHAPES:
            aff = torch.from_numpy(np.stack([0.5 + rng.rand(B, 64), 0.3 * rng.randn(B, 64)],
                                            axis=1).astype(np.float32)).cuda()
            for prologue in (True, False):
                y, st = block_cuda.conv_pass(x, w, b, aff, prologue)
                y_ref, st_ref = block_cuda.conv_pass_reference(x, w, b, aff, prologue)
                mags = torch.stack([y_ref.abs().sum(dim=(2, 3)), (y_ref * y_ref).sum(dim=(2, 3))],
                                   dim=1)
                err = (y - y_ref).abs().max().item()
                st_ratio = ((st - st_ref).abs() / mags).max().item()
                if not (err <= CONV_TOL and st_ratio <= STATS_TOL):
                    raise RuntimeError(f"conv3x3_stats_f32 {case} prologue {prologue}: "
                                       f"max_abs_err {err}, stats err/sum {st_ratio}")
                ms = [median_ms(torch, lambda: block_cuda.conv_pass(x, w, b, aff, prologue))
                      for _ in range(2)]
                out[f"conv3x3_stats_f32 {case} prologue {'on' if prologue else 'off'}"] = dict(
                    ms=sum(ms) / 2, library_ms=library_ms, bound_ms=bound_ms, max_abs_err=err)
        del x, w, b
        torch.cuda.empty_cache()
    return out


def show(label: str, res: dict) -> None:
    for case, r in res.items():
        print(f"{label}: {case}: {r['ms']:.4f} ms, F.conv2d {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['ms'] / r['bound_ms']:.2f}x), max_abs_err "
              f"{r['max_abs_err']:.3g}", flush=True)


def against(other: Path) -> dict:
    """``run`` in the checkout ``other`` and in this one, in four processes
    in turns (other, this, this, other): each case's two times of each."""
    here = Path(__file__).resolve().parents[2]
    runs = {"other": [], "this": []}
    for side, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"profile_conv_f32 in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        show(f"{side} ({tree})", res)
        runs[side].append(res)
    return {case: {"other_ms": [r[case]["ms"] for r in runs["other"]],
                   "this_ms": [r[case]["ms"] for r in runs["this"]],
                   "library_ms": [r[case]["library_ms"] for r in runs["other"] + runs["this"]],
                   "bound_ms": runs["this"][0][case]["bound_ms"]}
            for case in runs["this"][0] if case in runs["other"][0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose kernels to time in turns with these")
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the pips_tpu_torch of this checkout (used by --against)")
    args = ap.parse_args(argv)
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    if args.against is not None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        res = against(args.against.resolve())
        for case, r in res.items():
            print(f"{case}: {'/'.join(f'{v:.4f}' for v in r['other_ms'])} -> "
                  f"{'/'.join(f'{v:.4f}' for v in r['this_ms'])} ms, F.conv2d "
                  f"{'/'.join(f'{v:.4f}' for v in r['library_ms'])}, bound {r['bound_ms']:.4f}",
                  flush=True)
    else:
        res = run()
        if args.tree is None:
            show("kernels", res)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
