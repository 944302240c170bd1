"""Shared eval-runner utilities (counterpart of ``pips_tpu/evals/common.py``):
the eval model factory, weight loading (the port's checkpoints, the JAX
package's or the reference's ``model-*.pth``), the RAFT and DINO baseline
trackers, host-side resizing that matches the JAX runners' preprocessing,
the shared PIPs window tracker and the eval media.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``;
without a card it raises (``models.pips.resolve_device``) and never falls
back to the CPU.
"""

from __future__ import annotations

import glob
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from pips_tpu_torch.convert import load_flax_params
from pips_tpu_torch.inference.window import WindowTracker
from pips_tpu_torch.models.pips import Pips, init_params, resolve_device
from pips_tpu_torch.train.config import resolve_dtype, resolve_fuse_chanff
from pips_tpu_torch.utils import flax_msgpack, saverloader


def make_pips(S: int = 8, stride: int = 8, dtype: str = "float32", device="cuda") -> Pips:
    """Eval/serving model factory, in eval mode on ``device``. ``--dtype
    bfloat16`` runs the bf16 compute path with the fused channel block on
    CUDA (``csrc/chanff_fwd.cu``, 12 calls per refinement iteration), as the
    JAX factory turns its kernel on for bf16 on the TPU; the default float32
    runs the plain path. Weights come from ``load_params``."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype)
    fuse = resolve_fuse_chanff(-1, dt, device)
    return Pips(S=S, stride=stride, dtype=dt, fuse_chanff=fuse).to(device).eval()


def load_params(model: Pips, init_dir: str) -> Pips:
    """Load weights into ``model`` in place and return it, from a directory
    of the port's ``model-*.pt`` checkpoints (the ``"model"`` entry of a
    train-loop payload, or a bare state dict), a directory of the JAX
    package's ``model-*.msgpack`` checkpoints (a train state's ``params``, or
    a bare ``{"params": ...}`` variables tree, at the largest step), a
    reference ``model-*.pth`` file or a directory of them, or ``"random"``
    for ``init_params(seed 0)`` (smoke runs); raises with guidance otherwise."""
    if init_dir == "random":
        print("warning: using randomly initialized weights (smoke mode)")
        return init_params(model, 0)

    if os.path.isdir(init_dir) and saverloader.list_steps(init_dir):
        raw, step = saverloader.load_raw(init_dir)
        # strict: names every missing, unexpected or mis-shaped entry
        model.load_state_dict(raw["model"] if isinstance(raw.get("model"), Mapping) else raw)
        print(f"loaded pips_tpu_torch checkpoint at step {step} from {init_dir}")
        return model

    if os.path.isdir(init_dir) and flax_msgpack.list_steps(init_dir):
        raw, step = flax_msgpack.load_raw(init_dir)
        variables = raw["params"] if {"opt_state", "step"} <= set(raw) else raw
        if not isinstance(variables, Mapping) or "params" not in variables:
            raise ValueError(f"checkpoint in {init_dir} has no 'params' sub-tree "
                             f"(top-level keys: {sorted(raw)})")
        load_flax_params(model, variables)  # strict, as flax's from_state_dict
        print(f"loaded pips_tpu checkpoint at step {step} from {init_dir}")
        return model

    pths = []
    if os.path.isfile(init_dir) and init_dir.endswith(".pth"):
        pths = [init_dir]
    elif os.path.isdir(init_dir):
        pths = sorted(glob.glob(os.path.join(init_dir, "*.pth")))
    if pths:
        from pips_tpu_torch.torchport import load_torch_checkpoint
        print(f"porting torch checkpoint {pths[-1]}")
        depth = model.delta_block.to_delta.depth
        return load_flax_params(model, {"params": load_torch_checkpoint(pths[-1], depth)})

    raise FileNotFoundError(f"no checkpoint found at {init_dir} "
                            f"(expected model-*.pt, model-*.msgpack or model-*.pth)")


DINO_RELEASE_FILE = "dino_deitsmall8_pretrain.pth"


def _numpy_state_dict(sd: Mapping) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def load_raft_state_dict(init_dir: str) -> dict:
    """RAFT state_dict as numpy arrays from a local ``.pth`` (the published
    ``raft-things.pth``, or a file holding it under ``"model_state_dict"``),
    read with ``weights_only=True``."""
    sd = torch.load(init_dir, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return _numpy_state_dict(sd)


def load_dino_state_dict(init_dir: str) -> dict:
    """DINO ViT state_dict as numpy arrays, from a local ``.pth`` (the DINO
    release's ``dino_deitsmall8_pretrain.pth``, or a file holding it under
    ``"state_dict"``), read with ``weights_only=True``. The port never
    fetches weights: a missing file raises ``FileNotFoundError``."""
    if not init_dir or not os.path.isfile(init_dir):
        raise FileNotFoundError(
            f"dino checkpoint {init_dir!r} not found; the port reads DINO weights only from "
            f"a local file: download {DINO_RELEASE_FILE} from the DINO release and pass "
            f"--init_dir <path>")
    sd = torch.load(init_dir, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return _numpy_state_dict(sd)


def infer_dino_arch(sd: dict) -> tuple[int, int, int, int]:
    """(dim, depth, heads, patch) from a DINO ViT state dict (heads via the
    64-dim-per-head ViT convention: S/8 -> 6, B/8 -> 12)."""
    dim = int(sd["cls_token"].shape[-1])
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    patch = int(sd["patch_embed.proj.weight"].shape[-1])
    return dim, depth, max(dim // 64, 1), patch


def build_baseline_tracker(modeltype: str, init_dir: str, raft_iters: int = 32, device="cuda"):
    """Baseline tracker shared by the FLT/BADJA/CroHD eval runners
    (reference runs raft and dino on every benchmark: ``test_on_flt.py:123-161``,
    ``test_on_badja.py:161-539``, ``test_on_crohd.py:65-222``), in f32 on
    ``device`` (CUDA unless ``device="cpu"``).

    ``init_dir`` is the checkpoint file: RAFT's ``raft-things.pth`` layout
    (``module.`` prefixes stripped) or DINO's release file. Returns
    ``fn(xys (1,N,2), rgbs (1,T,H,W,3) [0,255]) -> trajs_e (1,T,N,2)`` numpy,
    for any T (full-video for BADJA, S-frame windows for FLT/CroHD).
    """
    from pips_tpu_torch.convert import load_flax_params
    from pips_tpu_torch.torchport import convert_dino_vit_state_dict, convert_raft_state_dict

    device = resolve_device(device)
    if modeltype == "raft":
        from pips_tpu_torch.inference.flow_chain import FlowChainTracker
        from pips_tpu_torch.models.raft import RAFT, Raftnet

        model = load_flax_params(RAFT(), convert_raft_state_dict(load_raft_state_dict(init_dir)))
        tracker = FlowChainTracker(Raftnet(model, iters=raft_iters, device=device).forward,
                                   device=device)
        return lambda xys, rgbs: tracker.track(np.asarray(rgbs), np.asarray(xys, np.float32))

    if modeltype == "dino":
        from pips_tpu_torch.models.dino import DinoTracker

        sd = load_dino_state_dict(init_dir)
        dim, depth, heads, patch = infer_dino_arch(sd)
        trackers: dict = {}  # the pos-embed's resize is per patch-grid shape

        def track(xys, rgbs):
            H, W = rgbs.shape[2:4]
            if H % patch or W % patch:
                raise ValueError(f"dino needs H,W divisible by {patch}, got {(H, W)}")
            key = (H // patch, W // patch)
            if key not in trackers:
                variables = convert_dino_vit_state_dict(sd, grid_hw=key, dim=dim, heads=heads,
                                                        depth=depth)
                trackers[key] = DinoTracker(
                    DinoTracker.make_vit_feat_fn(variables, patch, dim=dim, depth=depth,
                                                 heads=heads, device=device),
                    patch_size=patch, device=device)
            return trackers[key].track(np.asarray(rgbs[0]), np.asarray(xys[0], np.float32))[None]

        return track

    raise ValueError(f"unknown baseline modeltype {modeltype!r}")


def resize_video_half_pixel(rgbs: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(S, H, W, C) bilinear resize with half-pixel centers, on the host.

    Antialiased where it shrinks, as the JAX runners' ``jax.image.resize(...,
    method="linear")`` is (its triangle kernel widens by the scale on a
    shrinking axis): ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=True)``, which equals plain bilinear on an enlarging axis."""
    x = torch.from_numpy(np.ascontiguousarray(rgbs, np.float32)).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def resize_video_nearest(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(S, H, W) nearest resize (torch ``F.interpolate(mode='nearest')``)."""
    S, H, W = x.shape
    ys = (np.arange(out_hw[0]) * H / out_hw[0]).astype(np.int64)
    xs = (np.arange(out_hw[1]) * W / out_hw[1]).astype(np.int64)
    return x[:, ys][:, :, xs]


def build_pips_tracker(init_dir: str, S: int, stride: int, iters: int,
                       dtype: str = "float32", corr_mode: str = "onehot", device="cuda"):
    """Fixed-window PIPs tracker: fn(xys (1,N,2), rgbs (1,S,H,W,3)) ->
    trajs_e (1,S,N,2) numpy. The shared pips branch of every eval runner."""
    model = load_params(make_pips(S=S, stride=stride, dtype=dtype, device=device), init_dir)
    tracker = WindowTracker(model, iters=iters, corr_mode=corr_mode, device=device)
    return lambda xys, rgbs: tracker(xys, rgbs)[0]


def emit_eval_media(writer, step: int, rgbs: np.ndarray, trajs_g: np.ndarray,
                    trajs_e: np.ndarray, valids: np.ndarray, ate: float,
                    fps: int = 8) -> None:
    """The reference eval scripts' media pair (``test_on_flt.py:58,106``,
    ``test_on_crohd.py:102,152``): gt trajs in 'winter' on the time-mean
    frame with the ATE stamped top-left, plus the estimated trajs as a
    per-frame 'spring' gif. rgbs (S,H,W,3) float 0..255; trajs (S,N,2);
    valids (S,N)."""
    from pips_tpu_torch.utils.improc import Summ_writer, preprocess_color

    sw = Summ_writer(writer, global_step=step, log_freq=1, fps=fps)
    rgb_mean = preprocess_color(rgbs.mean(axis=0))
    sw.summ_traj2ds_on_rgb("inputs_0_all/single_trajs_on_rgb", trajs_g,
                           rgb_mean, valids=valids, cmap="winter",
                           linewidth=2, frame_id=ate)
    sw.summ_traj2ds_on_rgbs("outputs/trajs_on_rgbs", trajs_e,
                            preprocess_color(rgbs), cmap="spring",
                            linewidth=2)
