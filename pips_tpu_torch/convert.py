"""Parameter bridge between the JAX package's flax variables (``Pips``,
``Pips2``, the RAFT and DINO baselines) and the port's ``state_dict``
(counterpart of ``pips_tpu/torchport/convert.py``).

The port names its modules after the flax tree, so a leaf maps by path:

* ``.../<conv>/Conv_0/kernel`` (kH, kW, I, O) <-> ``<conv>.weight`` (O, I, kH, kW)
* ``.../<conv>/Conv_0/bias`` <-> ``<conv>.bias``
* every other ``kernel`` keeps its name and flax's layout: dense (I, O),
  Pips2's depthwise temporal conv (3, 1, D) (``models.pips2.TemporalConv``),
  bare ``nn.Conv`` layers (kH, kW, I, O) (RAFT's GRU, the ViT's patch
  embedding), the attention's (dim, heads, head_dim) and (heads, head_dim,
  dim) projections (``models.dino``); so do LayerNorm ``scale``, every other
  ``bias`` and the ViT's ``cls_token`` and ``pos_embed``.
* ``batch_stats`` ``mean`` and ``var`` (RAFT's batch norms) <-> the buffers
  ``<norm>.mean`` and ``<norm>.var``.

The tree is the same with and without ``fuse_chanff`` (the fused blocks'
``_LNParams``/``_ChanFFParams`` mirror ``LN``/``ChannelMixFF``), so one bridge
serves both. Leaves are numpy arrays or CPU tensors (a bfloat16 tensor widens
to f32 exactly); every leaf is used exactly once.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_CONV = "Conv_0"


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):  # e.g. utils.flax_msgpack's leaves; bf16 widens exactly
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), _leaf(v)


_PARAM_LEAVES = ("kernel", "bias", "scale", "cls_token", "pos_embed")
_STAT_LEAVES = ("mean", "var")


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """``{"params": tree}``, with ``"batch_stats"`` where the model has
    batch norms -> the port's state_dict (numpy)."""
    if "params" not in variables or not set(variables) <= {"params", "batch_stats"}:
        raise ValueError(f"expected {{'params': ...[, 'batch_stats': ...]}}, got keys "
                         f"{sorted(variables)}")
    sd = {}
    for collection, allowed in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, a in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            if collection == "params" and mods and mods[-1] == _CONV:
                mods = mods[:-1]
                if leaf == "kernel":
                    if a.ndim != 4:
                        raise ValueError(f"conv kernel {'/'.join(path)} has shape {a.shape}")
                    leaf, a = "weight", a.transpose(3, 2, 0, 1)
                elif leaf != "bias":
                    raise ValueError(f"unknown conv leaf {'/'.join(path)}")
            elif leaf not in allowed:
                raise ValueError(f"unknown {collection} leaf {'/'.join(path)}")
            key = ".".join([*mods, leaf])
            if key in sd:
                raise ValueError(f"two leaves map to {key}")
            sd[key] = np.array(a, order="C")
    return sd


def flax_from_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of ``state_dict_from_flax``: the port's state_dict ->
    ``{"params": tree}``, with ``"batch_stats"`` where it holds ``mean`` and
    ``var`` buffers."""
    out: dict[str, Any] = {"params": {}}
    for key, v in sd.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        *mods, leaf = key.split(".")
        collection = "params"
        if leaf == "weight":
            if a.ndim != 4:
                raise ValueError(f"{key} is not a conv weight: shape {a.shape}")
            mods, leaf, a = [*mods, _CONV], "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "bias" and key[: -len("bias")] + "weight" in sd:
            mods = [*mods, _CONV]
        elif leaf in _STAT_LEAVES:
            collection = "batch_stats"
        elif leaf not in _PARAM_LEAVES:
            raise ValueError(f"unknown state_dict entry {key}")
        node = out.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(a, order="C")
    return out


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
