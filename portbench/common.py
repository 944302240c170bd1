"""What the traffic drivers share: seeds, the model under test, the clip
pool, the host clock, and the run's record."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.traffic.synthetic import SyntheticPointDataset

DTYPES = ("bfloat16", "float32")


@dataclasses.dataclass
class Context:
    """One run: the cell (``spec.cell``), its seed and window, whether to
    trace, the device (CUDA in a run; the tests pass the CPU) and the
    process's start on the host clock."""
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def work(self) -> dict:
        return self.cell["work"]

    @property
    def params(self) -> dict:
        return self.cell["work"]["params"]

    @property
    def model(self) -> dict:
        return self.cell["model"]


def seeds(seed: int) -> dict:
    """Independent 31-bit seeds for each thing a run draws, from any whole
    ``seed`` (the driver's exceed 32 bits)."""
    names = ("weights", "traffic", "sample")
    kids = np.random.SeedSequence(int(seed)).spawn(len(names))
    return {n: int(k.generate_state(1)[0] >> 1) for n, k in zip(names, kids)}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_model(model: dict, params: dict, device, train: bool):
    """The port's ``Pips`` at the configuration's widths and dtype, with the
    benchmark's parameters loaded (strict: both sides name the same tensors)."""
    import torch
    from pips_tpu_torch.models.pips import Pips

    if model["dtype"] not in DTYPES:
        raise ValueError(f"dtype is one of {DTYPES}, got {model['dtype']!r}")
    net = Pips(S=model["S"], stride=model["stride"], latent_dim=model["latent_dim"],
               corr_levels=model["corr_levels"], corr_radius=model["corr_radius"],
               mixer_dim=model["mixer_dim"], mixer_depth=model["mixer_depth"],
               dtype=getattr(torch, model["dtype"]) if model["dtype"] != "float32" else None,
               fuse_chanff=model["fuse_chanff"])
    net.load_state_dict(params, strict=True)
    net = net.to(device)
    return net.train() if train else net.eval()


def clip_pool(p: dict, S: int, seed: int, N: int = 8) -> list:
    """``p["pool_clips"]`` synthetic clips (sample dicts of numpy arrays,
    rgbs (S, H, W, 3) float32 in [0, 255]) from the frozen generator."""
    ds = SyntheticPointDataset(S=S, N=N, H=p["H"], W=p["W"], num_sprites=p["sprites"],
                               sprite_size=p["sprite_size"], max_vel=p["max_vel"], seed=seed)
    return [ds[i][0] for i in range(p["pool_clips"])]


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    import torch

    dev = torch.device(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def judged(checks: dict, failed: int) -> bool:
    """Correct: every number within its limit, and no unit failed."""
    return failed == 0 and bool(checks) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
