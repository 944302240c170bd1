"""Convert reference PyTorch checkpoints (PIPs, and the RAFT and DINO
baselines) to the flax-layout param tree (a copy of
``pips_tpu/torchport/convert.py``'s key maps; the arrays are numpy).
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

from pips_tpu_torch.ops.resize import resize_half_pixel


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


def convert_raft_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """RAFT torch state_dict -> flax {params, batch_stats} for
    ``pips_tpu_torch.models.raft.RAFT``. Accepts 'module.' / 'model.module.' prefixes
    (the reference wraps RAFT in DataParallel, ``nets/raftnet.py:27``)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    for prefix in ("model.module.", "module."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    def conv_at(dst_path, src):
        put(params, list(dst_path) + ["Conv_0", "kernel"],
            np.transpose(sd[src + ".weight"], (2, 3, 1, 0)))
        put(params, list(dst_path) + ["Conv_0", "bias"], sd[src + ".bias"])

    def bn_at(dst_path, src):
        put(params, list(dst_path) + ["scale"], sd[src + ".weight"])
        put(params, list(dst_path) + ["bias"], sd[src + ".bias"])
        put(stats, list(dst_path) + ["mean"], sd[src + ".running_mean"])
        put(stats, list(dst_path) + ["var"], sd[src + ".running_var"])

    for enc, norm in (("fnet", "instance"), ("cnet", "batch")):
        conv_at((enc, "conv1"), f"{enc}.conv1")
        conv_at((enc, "conv2"), f"{enc}.conv2")
        if norm == "batch":
            bn_at((enc, "norm1"), f"{enc}.norm1")
        for stage in (1, 2, 3):
            for blk in (0, 1):
                src = f"{enc}.layer{stage}.{blk}"
                dst = (enc, f"layer{stage}_{blk}")
                conv_at(dst + ("conv1",), src + ".conv1")
                conv_at(dst + ("conv2",), src + ".conv2")
                if norm == "batch":
                    bn_at(dst + ("norm1",), src + ".norm1")
                    bn_at(dst + ("norm2",), src + ".norm2")
                if f"{src}.downsample.0.weight" in sd:
                    conv_at(dst + ("downsample",), src + ".downsample.0")
                    if norm == "batch":
                        bn_at(dst + ("norm3",), src + ".norm3")

    ub = ("update_block",)
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        conv_at(ub + ("encoder", name), f"update_block.encoder.{name}")
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        put(params, list(ub) + ["gru", name, "kernel"],
            np.transpose(sd[f"update_block.gru.{name}.weight"], (2, 3, 1, 0)))
        put(params, list(ub) + ["gru", name, "bias"],
            sd[f"update_block.gru.{name}.bias"])
    conv_at(ub + ("flow_head", "conv1"), "update_block.flow_head.conv1")
    conv_at(ub + ("flow_head", "conv2"), "update_block.flow_head.conv2")
    conv_at(ub + ("mask1",), "update_block.mask.0")
    conv_at(ub + ("mask2",), "update_block.mask.2")

    return {"params": params, "batch_stats": stats}


def convert_dino_vit_state_dict(sd: Mapping[str, np.ndarray], grid_hw=None,
                                dim: int = 384, heads: int = 6,
                                depth: int = 12) -> Dict[str, Any]:
    """DINO ViT (facebookresearch/dino hub) state_dict -> flax params for
    ``pips_tpu_torch.models.dino.ViT``. ``grid_hw``: target patch-grid (h, w)
    for the pos-embed's resize (DINO trains at 28x28 for ViT-S/8), Keys'
    cubic as ``jax.image.resize(..., method="cubic")`` computes it
    (``ops.resize.resize_matrix``: antialiased where it shrinks)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    head_dim = dim // heads

    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.transpose(sd["patch_embed.proj.weight"], (2, 3, 1, 0)),
            "bias": sd["patch_embed.proj.bias"],
        },
        "cls_token": sd["cls_token"],
        "norm": _ln(sd["norm.weight"], sd["norm.bias"]),
    }

    pos = sd["pos_embed"]  # (1, 1+n, dim)
    if grid_hw is not None:
        n = pos.shape[1] - 1
        side = int(round(n ** 0.5))
        grid = torch.from_numpy(np.ascontiguousarray(pos[0, 1:].reshape(side, side, dim)))
        grid = resize_half_pixel(grid.permute(2, 0, 1), tuple(grid_hw), "cubic").permute(1, 2, 0)
        pos = np.concatenate([pos[:, :1], grid.numpy().reshape(1, -1, dim)], axis=1)
    params["pos_embed"] = pos

    for d in range(depth):
        p = f"blocks.{d}"
        qkv_w = sd[f"{p}.attn.qkv.weight"]  # (3*dim, dim)
        qkv_b = sd[f"{p}.attn.qkv.bias"]
        qw, kw, vw = np.split(qkv_w, 3, axis=0)
        qb, kb, vb = np.split(qkv_b, 3, axis=0)

        def head_proj(w, b):
            return {"kernel": np.ascontiguousarray(w.T).reshape(dim, heads, head_dim),
                    "bias": b.reshape(heads, head_dim)}

        params[f"block{d}"] = {
            "norm1": _ln(sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"]),
            "attn": {
                "query": head_proj(qw, qb),
                "key": head_proj(kw, kb),
                "value": head_proj(vw, vb),
                "out": {
                    "kernel": np.ascontiguousarray(
                        sd[f"{p}.attn.proj.weight"].T).reshape(heads, head_dim, dim),
                    "bias": sd[f"{p}.attn.proj.bias"],
                },
            },
            "norm2": _ln(sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"]),
            "fc1": _dense(sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"]),
            "fc2": _dense(sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"]),
        }
    return {"params": params}


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
