"""Build and load the port's CUDA kernels (counterpart of ``pips_tpu/kernels/__init__.py``).

Each ``pips_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``. No PyTorch
headers are involved, so a build takes seconds. Libraries land in
``<repo>/build/pips_tpu_torch/`` under a name keyed by a hash of the sources
and flags, so a stale library is never loaded; delete that directory to force
a rebuild. Builds happen at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pips_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source under ``csrc/`` that has no library for its
    current hash, all ``nvcc`` processes at once. Returns, per source stem,
    ``{"path", "cached", "seconds"}``; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not _target(s).exists() for s in CSRC.glob("*.cu")) else None
    info, running = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            info[src.stem] = {"path": str(out), "cached": True, "seconds": 0.0}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running.append((src, out, tmp, log, proc, time.perf_counter()))
    for src, out, tmp, log, proc, t0 in running:
        text, _ = proc.communicate()
        log.write_bytes(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
                               + text.decode(errors="replace"))
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        info[src.stem] = {"path": str(out), "cached": False,
                          "seconds": time.perf_counter() - t0}
    return info


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = _libs.get(stem)
    if lib is None:
        lib = ctypes.CDLL(build_all()[stem]["path"])
        _libs[stem] = lib
    return lib
