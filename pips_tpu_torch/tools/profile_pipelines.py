"""Where the time of the two pipelined tensor-core kernels goes, on the card.

The bf16 ``stem_wgrad`` kernel (``csrc/stem_wgrad.cu``) and ``stream_accum``
(``csrc/mixer_probes.cu``) each overlap a ring of asynchronous copies with
wgmma products. No kernel profiler runs on the machine with the card, so this
tool builds variants of each source with one phase taken out and times them
beside the kernel, at the smoke's shapes: what a phase costs is the time it
adds. A variant's output is wrong by construction; only the kernel's is held
to its plain version.

    python3 -m pips_tpu_torch.tools.profile_pipelines

Variants of ``stem_wgrad`` (B=8 and B=1, 384x512, as many blocks as the
kernel takes): "kernel"; "no x copies" (the producers skip x2's rows); "no
products" (the warpgroup skips its wgmma); "dy only" (both); "no segments"
(no block gets a segment: the launch, the partial sums and the second
launch). Of ``stream_accum`` (``tools/debug_mixer_kernel.py``'s x (128, 4096)
and w1 (12, 512, 2048)): "kernel"; "no products"; "no copies" (the producer
only arrives, so the products read stale tiles). Times: CUDA events around
``reps`` calls queued behind a sleep kernel (so the host's cost per call
hides), the median of ``rounds``. Prints one JSON line with the card's name
and power limit; needs CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from pips_tpu_torch.kernels import _build
from pips_tpu_torch.kernels.mixer_probes_cuda import stream_accum_reference
from pips_tpu_torch.kernels.stem_wgrad_cuda import stem_wgrad_reference
from pips_tpu_torch.tools import debug_mixer_kernel

ROUNDS, REPS = 7, 20
STEM_X = ("for (int r = 0; r < KY; ++r) {\n        const uint32_t* src",
          "for (int r = 0; r < 0; ++r) {\n        const uint32_t* src")
STEM_MMA = ("          wgmma_m64n32k16_rs<1>(", "          if (ks < 0) wgmma_m64n32k16_rs<1>(")
STEM_NONE = ("const int n = (int)(s1 - s0);", "const int n = 0 * (int)(s1 - s0);")
SA_MMA = ("        wgmma_m64n64k16<0, 1>(acc,\n",
          "        if (ks < 0) wgmma_m64n64k16<0, 1>(acc,\n")
SA_COPY = [("        mbar_arrive_expect_tx(&full[s], kWTile + (i == 0 ? kXBytes : 0));",
            "        mbar_arrive(&full[s]);"),
           ("        for (int h = 0; i == 0 && h < kBK / 64; ++h)",
            "        for (int h = 0; i < 0 && h < kBK / 64; ++h)"),
           ("        tma_load_2d(ws + s * kWTile,",
            "        if (i < 0) tma_load_2d(ws + s * kWTile,")]
VARIANTS = {
    "stem_wgrad": {"kernel": [], "no x copies": [STEM_X], "no products": [STEM_MMA],
                   "dy only": [STEM_X, STEM_MMA], "no segments": [STEM_NONE]},
    "mixer_probes": {"kernel": [], "no products": [SA_MMA], "no copies": SA_COPY},
}


def build() -> dict:
    """Every variant's library, all nvcc processes at once, under
    ``build/pips_tpu_torch/variants``: {(source, variant): ctypes.CDLL}."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, running = _build._nvcc(), []
    for stem, variants in VARIANTS.items():
        src = (_build.CSRC / f"{stem}.cu").read_text()
        for i, (name, subs) in enumerate(variants.items()):
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{stem}.cu no longer holds {old!r} once: update the "
                                       "variant")
                text = text.replace(old, new)
            cu, so = out / f"{stem}_{i}.cu", out / f"lib{stem}_{i}.so"
            cu.write_text(text)
            proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                                     str(so), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            running.append((stem, name, so, proc))
    libs = {}
    for stem, name, so, proc in running:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {stem} variant {name!r}:\n"
                               + text.decode(errors="replace"))
        libs[(stem, name)] = ctypes.CDLL(str(so))
    return libs


def device_ms(call, rounds: int = ROUNDS, reps: int = REPS) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls queued
    behind a sleep kernel, per call."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return sorted(times)[len(times) // 2]


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stem_variants(libs: dict, B: int, H: int = 384, W: int = 512) -> dict:
    Ho, Wo = H // 2, W // 2
    rng = np.random.RandomState(B)
    x2, dy = (torch.from_numpy((rng.rand(*shape) - 0.5).astype(np.float32)).cuda().bfloat16()
              .permute(0, 3, 1, 2) for shape in ((B, 2 * Ho + 6, Wo + 3, 6), (B, Ho, Wo, 64)))
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in VARIANTS["stem_wgrad"]:
        lib = libs[("stem_wgrad", name)]
        lib.pips_stem_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.pips_stem_wgrad_blocks.argtypes = [ctypes.c_int] * 5
        nb = lib.pips_stem_wgrad_blocks(B, Ho, Wo, 1, x2.device.index)
        dk = torch.empty(64, 6, 7, 4, device="cuda")
        part = torch.empty(nb, dk.numel(), device="cuda")

        def call(lib=lib, nb=nb, dk=dk, part=part):
            checked(lib.pips_stem_wgrad(x2.data_ptr(), dy.data_ptr(), dk.data_ptr(),
                                        part.data_ptr(), nb, B, x2.shape[2], x2.shape[3], Ho,
                                        Wo, 1, x2.device.index, stream), f"stem_wgrad {name}")

        out[name] = device_ms(call)
        if name == "kernel":
            err = (dk - stem_wgrad_reference(x2, dy)).abs().max().item()
            out["kernel max_abs_err"] = err
            out["blocks"] = nb
    return out


def stream_variants(libs: dict) -> dict:
    x, w1 = debug_mixer_kernel.inputs("cuda")
    M, (NB, K, N) = x.shape[0], w1.shape
    o = torch.empty(M, N, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in VARIANTS["mixer_probes"]:
        fn = libs[("mixer_probes", name)].pips_probe_stream_accum
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

        def call(fn=fn):
            checked(fn(x.data_ptr(), w1.data_ptr(), o.data_ptr(), M, N, NB, x.stride(0),
                       x.device.index, stream), f"stream_accum {name}")

        out[name] = device_ms(call)
        if name == "kernel":
            out["kernel max_abs_err"] = (o - stream_accum_reference(x, w1)).abs().max().item()
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profile_pipelines times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    res = {"device": torch.cuda.get_device_name(0), "nvidia-smi": smi[0] if smi else None,
           "stem_wgrad B=8": stem_variants(libs, 8), "stem_wgrad B=1": stem_variants(libs, 1),
           "stream_accum": stream_variants(libs)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
