"""Checkpoint save/load (counterpart of ``pips_tpu/utils/saverloader.py``), with
its operational semantics: ``model-%09d`` names, an atomic tmp-then-replace
write, keep-latest pruning, resume from the largest step, and
substring-based ``ignore_load`` filtering for partial warm starts.

The payload is the port's own: one ``torch.save`` file per step holding a
dict of state dicts, ``{"model": model.state_dict(), "optimizer":
Optimizer.state_dict()}`` for the train loop, with tensors moved to the host.
Reading the JAX package's msgpack checkpoints is not part of this module.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping, Optional, Sequence

import torch

_PATTERN = re.compile(r"model-(\d{9})\.pt$")


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"model-{step:09d}.pt")


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _PATTERN.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def save(ckpt_dir: str, tree: Mapping[str, Any], step: int, keep_latest: int = 1) -> str:
    """Write ``tree`` (a dict of state dicts) at ``step``; keep the latest
    ``keep_latest`` checkpoints (all of them when it is 0)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)

    if keep_latest > 0:
        for old_step in list_steps(ckpt_dir)[:-keep_latest]:
            try:
                os.remove(_ckpt_path(ckpt_dir, old_step))
            except OSError:
                pass
    return path


def load_raw(ckpt_dir: str, step: Optional[int] = None) -> tuple[Any, int]:
    """The payload at the largest (or the given) step, whatever its layout:
    a train-loop payload (``{"model": ..., "optimizer": ...}``) or a bare
    state dict. Returns (payload, step); raises if no checkpoint exists."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    step = step if step is not None else steps[-1]
    return torch.load(_ckpt_path(ckpt_dir, step), map_location="cpu", weights_only=True), step


def load(ckpt_dir: str, target: Mapping[str, Any], step: Optional[int] = None,
         ignore_load: Optional[Sequence[str] | str] = None) -> tuple[dict, int]:
    """Restore the entries of ``target`` (e.g. ``{"model": ..., "optimizer":
    ...}``) from the largest (or the given) step.

    ``ignore_load``: substrings; any entry of ``target["model"]`` whose name
    contains one keeps the target's value. Returns (tree, step); (target, 0)
    if no checkpoint exists.
    """
    steps = list_steps(ckpt_dir)
    if not steps:
        print(f"-- note: no checkpoint found in {ckpt_dir}; starting fresh")
        return dict(target), 0
    step = step if step is not None else steps[-1]
    saved = torch.load(_ckpt_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    missing = sorted(set(target) - set(saved))
    if missing:
        raise KeyError(f"checkpoint {_ckpt_path(ckpt_dir, step)} has no {missing}")
    restored = {k: saved[k] for k in target}
    if ignore_load and "model" in target:
        if isinstance(ignore_load, str):
            ignore_load = [ignore_load]
        model = dict(restored["model"])
        for key in model:
            if any(ig in key for ig in ignore_load):
                print(f"-- ignoring load of {key}")
                model[key] = target["model"][key]
        restored["model"] = model
    return restored, step
