"""Parameter bridge between the JAX ``Pips`` and ``Pips2`` param trees and the
port's ``state_dict`` (counterpart of ``pips_tpu/torchport/convert.py``).

The port names its modules after the flax tree, so a leaf maps by path:

* ``.../<conv>/Conv_0/kernel`` (kH, kW, I, O) <-> ``<conv>.weight`` (O, I, kH, kW)
* ``.../<conv>/Conv_0/bias`` <-> ``<conv>.bias``
* dense ``kernel`` (I, O), Pips2's depthwise temporal conv ``tconv/kernel``
  (3, 1, D) (``models.pips2.TemporalConv`` keeps flax's layout), LayerNorm
  ``scale`` and every other ``bias`` keep their name and layout.

The tree is the same with and without ``fuse_chanff`` (the fused blocks'
``_LNParams``/``_ChanFFParams`` mirror ``LN``/``ChannelMixFF``), so one bridge
serves both. Arrays are numpy; every leaf is used exactly once.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_CONV = "Conv_0"


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """``{"params": tree}`` of the JAX ``Pips`` or ``Pips2`` -> the port's state_dict (numpy)."""
    if set(variables) != {"params"}:
        raise ValueError(f"expected {{'params': ...}}, got keys {sorted(variables)}")
    sd = {}
    for path, a in _flatten(variables["params"]):
        *mods, leaf = path
        if mods and mods[-1] == _CONV:
            mods = mods[:-1]
            if leaf == "kernel":
                if a.ndim != 4:
                    raise ValueError(f"conv kernel {'/'.join(path)} has shape {a.shape}")
                leaf, a = "weight", a.transpose(3, 2, 0, 1)
            elif leaf != "bias":
                raise ValueError(f"unknown conv leaf {'/'.join(path)}")
        elif leaf not in ("kernel", "bias", "scale"):
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        key = ".".join([*mods, leaf])
        if key in sd:
            raise ValueError(f"two leaves map to {key}")
        sd[key] = np.array(a, order="C")
    return sd


def flax_from_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of ``state_dict_from_flax``: the port's state_dict -> ``{"params": tree}``."""
    tree: dict[str, Any] = {}
    for key, v in sd.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        *mods, leaf = key.split(".")
        if leaf == "weight":
            if a.ndim != 4:
                raise ValueError(f"{key} is not a conv weight: shape {a.shape}")
            mods, leaf, a = [*mods, _CONV], "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "bias" and key[: -len("bias")] + "weight" in sd:
            mods = [*mods, _CONV]
        elif leaf not in ("kernel", "bias", "scale"):
            raise ValueError(f"unknown state_dict entry {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(a, order="C")
    return {"params": tree}


def load_flax_params(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX params into ``model``; raises on any missing, extra or
    mis-shaped entry."""
    sd = state_dict_from_flax(variables)
    own = model.state_dict()
    missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"param tree does not fit the model: missing {missing}, extra {extra}")
    for k, v in own.items():
        if tuple(v.shape) != sd[k].shape:
            raise ValueError(f"{k}: model has {tuple(v.shape)}, params have {sd[k].shape}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model
