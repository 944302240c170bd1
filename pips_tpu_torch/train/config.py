"""Training configuration (counterpart of ``pips_tpu/train/config.py``): the same
fields with the same defaults, ``model_name()``, and the fire-like CLI that maps
``--key value`` / ``--key=value`` onto fields with type coercion, so
``python -m pips_tpu_torch.train.loop --B 4 --lr 5e-4`` works as the JAX
package's train loop does.

``resolve_dtype`` turns the ``dtype`` string into the model's compute dtype;
``resolve_fuse_chanff`` turns a -1/0/1 kernel flag (``fuse_chanff``,
``fuse_conv3``) into on or off for the device the loop runs on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass
class TrainConfig:
    exp_name: str = "debug"
    # training
    B: int = 4
    S: int = 8
    N: int = 768
    horz_flip: bool = True
    vert_flip: bool = True
    stride: int = 8
    I: int = 4
    # model dims (the reference's hyperparameters)
    latent_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 3
    mixer_dim: int = 512
    mixer_depth: int = 12
    crop_size: Sequence[int] = (384, 512)
    use_augs: bool = True
    # dataset
    dataset: str = "flyingthings"   # flyingthings | pointodyssey | synthetic
    dataset_location: str = "/data/flyingthings"
    subset: str = "all"
    shuffle: bool = True
    # optimization
    lr: float = 5e-4
    wdecay: float = 1e-4
    grad_acc: int = 1
    max_iters: int = 200000
    use_scheduler: bool = True
    # summaries
    log_dir: str = "logs_train"
    log_freq: int = 4000
    log_media: bool = True   # emit traj GIF + score-map render every log_freq
    model_family: str = "pips"  # "pips" (fixed-S mixer) or "pips2" (S-agnostic PIPs++)
    num_workers: int = 8   # host loader threads
    loader_processes: bool = False  # spawn worker PROCESSES instead of threads
    metrics_every: int = 10  # host-sync metrics every K steps (reading a metric
                             # waits for the device to finish the step)
    profile_dir: str = ""    # capture a torch.profiler trace of steps 10-15
    val_freq: int = 2000
    val_batches: int = 8   # batches per validation pass (pooled, n=10000)
    # saving/loading
    ckpt_dir: str = "checkpoints"
    save_freq: int = 1000
    keep_latest: int = 1
    init_dir: str = ""
    auto_resume: bool = True  # resume from this run's own latest checkpoint
                              # (full state + step) when one exists and no
                              # explicit init_dir is given
    load_optimizer: bool = False
    load_step: bool = False
    ignore_load: Optional[str] = None
    # device: data-parallel meshes and multi-host runs (ROADMAP A7) are refused
    # by the loop; None and (1, 1) are one device
    mesh_shape: Optional[Sequence[int]] = None
    multihost: bool = False
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1
    dtype: str = "bfloat16"   # compute dtype for the model ("float32" for exactness)
    use_fused_corr: bool = False  # Pips trains through the one-hot form either way;
                                  # Pips2 samples fused with it, full without
    # remats: recompute on the backward instead of keeping activations
    remat: bool = False        # whole-step remat
    remat_mixer: bool = False  # DeltaBlock remat
    remat_corr: bool = False   # recompute corr volumes on backward
    remat_encoder: bool = False  # per-block encoder remat
    fuse_chanff: int = -1  # fused channel-mixer kernels (csrc/chanff_fwd.cu,
                           # chanff_bwd.cu): -1 auto (on iff CUDA + bf16),
                           # 0 off, 1 on
    fuse_conv3: int = 0    # the encoder's stage-1 3x3 convs through
                           # csrc/conv3x3_fwd.cu: same -1/0/1 semantics as
                           # fuse_chanff, default off as in the JAX package
    # smoke mode
    quick: bool = False

    def model_name(self) -> str:
        """Descriptive run name (as the JAX package's and the reference's)."""
        eff_b = self.B * (2 if self.horz_flip else 1) * (2 if self.vert_flip else 1)
        name = f"{eff_b}"
        if self.horz_flip and self.vert_flip:
            name = f"{self.B * 4}hv"
        elif self.horz_flip:
            name = f"{self.B * 2}h"
        elif self.vert_flip:
            name = f"{self.B * 2}v"
        if self.grad_acc > 1:
            name += f"x{self.grad_acc}"
        name += f"_{self.S}_{self.N}_I{self.I}"
        lrn = f"{self.lr:.1e}"
        name += "_" + lrn[0] + lrn[3:5].lstrip("0") + lrn[-1]
        if self.use_augs:
            name += "_A"
        return name + f"_{self.exp_name}"


def _coerce(value: str, typ):
    if typ is bool or typ == "bool":
        return value.lower() in ("1", "true", "yes", "y")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is tuple:
        return tuple(int(v) for v in value.strip("()[] ").split(",") if v)
    return value


def parse_cli(argv: Sequence[str], cfg: Optional[TrainConfig] = None) -> TrainConfig:
    """Parse ``--key value`` / ``--key=value`` pairs onto TrainConfig fields."""
    cfg = cfg or TrainConfig()
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    updates = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        else:
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                value = argv[i + 1]
                i += 1
            else:
                value = "true"  # bare flag
        key = key.replace("-", "_")
        if key not in fields:
            raise SystemExit(f"unknown config field: --{key}; valid: {sorted(fields)}")
        f = fields[key]
        typ = f.type if f.type is not None else str
        if isinstance(typ, str):  # `from __future__ import annotations` strings
            base = typ.split("[")[0].strip()
            if base == "Optional":
                base = typ.split("[", 1)[1].rstrip("]").split("[")[0].strip()
            typ = {"int": int, "float": float, "bool": bool, "str": str,
                   "Sequence": tuple, "tuple": tuple, "list": tuple}.get(base, str)
        updates[key] = _coerce(value, typ)
        i += 1
    return dataclasses.replace(cfg, **updates)


def resolve_dtype(name: str) -> Optional[torch.dtype]:
    """Config dtype string -> model compute dtype (None keeps exact fp32)."""
    table = {"float32": None, "f32": None, "fp32": None,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unknown dtype {name!r}; use float32 or bfloat16")
    return table[name]


def resolve_fuse_chanff(flag: int, dtype: Optional[torch.dtype], device) -> bool:
    """-1 auto: the kernels iff the loop runs on CUDA with bf16 compute, as
    JAX's auto is "TPU and bf16"; 0 and 1 force. The CUDA kernels take f32
    too, forward and backward: ``--fuse_chanff 1 --dtype float32`` trains on
    the card."""
    if flag >= 0:
        return bool(flag)
    return torch.device(device).type == "cuda" and dtype == torch.bfloat16
