"""Convert reference PyTorch PIPs checkpoints to the flax-layout param tree
(a copy of ``pips_tpu/torchport/convert.py``'s PIPs key map; the arrays are
numpy).
``pips_tpu_torch.convert.load_flax_params`` loads its result into a port
model and raises on any missing, extra or mis-shaped leaf.

Layout conventions:
  * torch Conv2d weight (O, I, kH, kW)  -> flax Conv kernel (kH, kW, I, O)
  * torch Linear weight (O, I)          -> flax Dense kernel (I, O)
  * torch Conv1d(k=1) weight (O, I, 1)  -> flax Dense kernel (I, O)  (token mix)
  * norm weight/bias                    -> scale/bias

Only parameterized layers appear: the reference's InstanceNorm2d layers are
non-affine (torch defaults) and carry no state.

Key map follows the reference module tree (``nets/pips.py:400-426``):
fnet.{conv1,layer{1..4}.{0,1}.{conv1,conv2,downsample.0},conv2,conv3},
delta_block.to_delta.{0, 1..depth (token/chan pairs), LayerNorm, head},
norm, ffeat_updater.0, vis_predictor.0.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv(w: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    return {"Conv_0": {"kernel": np.transpose(w, (2, 3, 1, 0)), "bias": b}}


def _dense(w: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    return {"kernel": np.ascontiguousarray(w.T), "bias": b}


def _dense1d(w: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    # Conv1d kernel-size-1 weight (O, I, 1)
    return {"kernel": np.ascontiguousarray(w[:, :, 0].T), "bias": b}


def _ln(w: np.ndarray, b: np.ndarray) -> Dict[str, Any]:
    return {"scale": w, "bias": b}


def convert_pips_state_dict(sd: Mapping[str, np.ndarray],
                            mixer_depth: int = 12) -> Dict[str, Any]:
    """sd: torch state_dict with numpy (or tensor-like) values -> flax params dict."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def g(key: str) -> np.ndarray:
        return sd[key]

    fnet: Dict[str, Any] = {
        "conv1": _conv(g("fnet.conv1.weight"), g("fnet.conv1.bias")),
        "conv2": _conv(g("fnet.conv2.weight"), g("fnet.conv2.bias")),
        "conv3": _conv(g("fnet.conv3.weight"), g("fnet.conv3.bias")),
    }
    for stage in range(1, 5):
        for blk in range(2):
            p = f"fnet.layer{stage}.{blk}"
            dst: Dict[str, Any] = {
                "conv1": _conv(g(f"{p}.conv1.weight"), g(f"{p}.conv1.bias")),
                "conv2": _conv(g(f"{p}.conv2.weight"), g(f"{p}.conv2.bias")),
            }
            if f"{p}.downsample.0.weight" in sd:
                dst["downsample"] = _conv(g(f"{p}.downsample.0.weight"),
                                          g(f"{p}.downsample.0.bias"))
            fnet[f"layer{stage}_{blk}"] = dst

    to_delta: Dict[str, Any] = {
        "embed": _dense(g("delta_block.to_delta.0.weight"), g("delta_block.to_delta.0.bias")),
        "final_norm": _ln(g(f"delta_block.to_delta.{mixer_depth + 1}.weight"),
                          g(f"delta_block.to_delta.{mixer_depth + 1}.bias")),
        "head": _dense(g(f"delta_block.to_delta.{mixer_depth + 3}.weight"),
                       g(f"delta_block.to_delta.{mixer_depth + 3}.bias")),
    }
    for d in range(mixer_depth):
        p = f"delta_block.to_delta.{d + 1}"
        to_delta[f"block{d}_token_norm"] = _ln(g(f"{p}.0.norm.weight"), g(f"{p}.0.norm.bias"))
        to_delta[f"block{d}_token"] = {
            "fc1": _dense1d(g(f"{p}.0.fn.0.weight"), g(f"{p}.0.fn.0.bias")),
            "fc2": _dense1d(g(f"{p}.0.fn.3.weight"), g(f"{p}.0.fn.3.bias")),
        }
        to_delta[f"block{d}_chan_norm"] = _ln(g(f"{p}.1.norm.weight"), g(f"{p}.1.norm.bias"))
        to_delta[f"block{d}_chan"] = {
            "fc1": _dense(g(f"{p}.1.fn.0.weight"), g(f"{p}.1.fn.0.bias")),
            "fc2": _dense(g(f"{p}.1.fn.3.weight"), g(f"{p}.1.fn.3.bias")),
        }

    return {
        "fnet": fnet,
        "delta_block": {"to_delta": to_delta},
        "ffeat_norm": _ln(g("norm.weight"), g("norm.bias")),
        "ffeat_updater": _dense(g("ffeat_updater.0.weight"), g("ffeat_updater.0.bias")),
        "vis_predictor": _dense(g("vis_predictor.0.weight"), g("vis_predictor.0.bias")),
    }


def load_torch_checkpoint(path: str, mixer_depth: int = 12) -> Dict[str, Any]:
    """Load a reference ``model-*.pth`` checkpoint file into flax-layout params.

    Accepts the saverloader format (dict with 'model_state_dict';
    reference ``saverloader.py:16-21``) or a bare state_dict, and strips
    the ``module.`` prefix of a DataParallel model. The file is unpickled
    with ``weights_only=True``: tensors and plain containers only.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k.removeprefix("module."): v.detach().cpu().numpy() for k, v in sd.items()}
    return convert_pips_state_dict(sd, mixer_depth=mixer_depth)
