"""The stem conv's weight gradient: the kernel against the library's, on the card.

Counterpart of ``tools/profile_stem_wgrad.py``. For the stem's W-s2d conv
(stride (2, 1), VALID, 7x4 taps, 6 -> 64 channels) at B=1 and B=8, 384x512,
bf16, it prints dk's max|err| of ``kernels.stem_wgrad_cuda.stem_wgrad``
(``pips_tpu_torch/csrc/stem_wgrad.cu``) against the library's autograd, and
the row-tap (x7) form's difference from the conv; then times, forward and
forward+dk, in turns: "library" (``F.conv2d`` with autograd), "kernel"
(``stem_conv_s2d``: the library forward, the kernel's weight gradient) and
"x7" (the row taps folded into 42 channels, a stride-1 (1, 4)-tap conv).
Timing: ``profile_block_kernel.in_turns``: CUDA events around ``reps`` calls
(a synchronised host clock on the CPU), the median over ``rounds``, the
three in turns.

    python3 -m pips_tpu_torch.tools.profile_stem_wgrad

Runs on CUDA; ``run(..., device="cpu")`` runs the plain weight gradient
instead (tests).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pips_tpu_torch.kernels.stem_wgrad_cuda import stem_conv_s2d, stem_wgrad
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.tools.profile_block_kernel import in_turns

ROUNDS, REPS = 5, 10
SHAPES = ((1, 384, 512, "B=1 384x512 bf16"), (8, 384, 512, "B=8 384x512 bf16"))


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


def main(device: str = "cuda", rounds: int = ROUNDS, reps: int = REPS) -> dict:
    return {tag: run(B, H, W, torch.bfloat16, tag, device, rounds, reps)
            for B, H, W, tag in SHAPES}


if __name__ == "__main__":
    main()
