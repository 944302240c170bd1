"""BADJA keypoint propagation eval (counterpart of
``pips_tpu/evals/run_badja.py``; capability parity: reference
``test_on_badja.py``): resize to 320x512, chain 8-frame windows per keypoint
(batched through ``ChainTracker``, where the reference loops points one by
one), report per-video PCK@0.2*sqrt(seg area). Runs on CUDA unless
``--device cpu``; ``--modeltype raft|dino`` tracks each video whole with the
RAFT flow chain or DINO label propagation (``--init_dir`` their weights file).

    python -m pips_tpu_torch.evals.run_badja --init_dir <ckpt> --data_dir <badja>
"""

from __future__ import annotations

import os
import time

import numpy as np

from pips_tpu_torch.data.badja import BadjaDataset
from pips_tpu_torch.evals.common import load_params, resize_video_half_pixel, resize_video_nearest
from pips_tpu_torch.evals.metrics import pck_at_sqrt_area
from pips_tpu_torch.inference import ChainTracker
from pips_tpu_torch.models.pips import resolve_device


def write_kp_vis(out_dir: str, name: str, rgbs: np.ndarray,
                 trajs_e: np.ndarray, sigma: float = 4.0) -> str:
    """Colored keypoint blobs (SMAL region colors via summ_soft_seg_thr)
    composited over the grayscale video -> GIF. rgbs (T,H,W,3) float255;
    trajs_e (T,N,2)."""
    from pips_tpu_torch.data.badja import JOINT_COLORS
    from pips_tpu_torch.utils.improc import Summ_writer, draw_circles_at_xy, write_gif
    from pips_tpu_torch.utils.logging import MetricWriter

    T, H, W, _ = rgbs.shape
    N = trajs_e.shape[1]
    sw = Summ_writer(MetricWriter(out_dir, use_tensorboard=False), 0, log_freq=1)
    colors = JOINT_COLORS[:N] if N <= len(JOINT_COLORS) else None
    frames = []
    for t in range(T):
        kp = draw_circles_at_xy(trajs_e[t], H, W, sigma=sigma)  # (N, H, W)
        seg = sw.summ_soft_seg_thr("", kp, label_colors=colors,
                                   thr=0.5, only_return=True)
        gray = np.mean(rgbs[t], axis=-1, keepdims=True)
        base = np.repeat(np.clip(gray, 0, 255), 3, axis=-1).astype(np.uint8)
        any_kp = kp.max(axis=0) >= 0.5
        frame = np.where(any_kp[..., None], seg, base)
        frames.append(frame)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}_kp_vis.gif")
    write_gif(path, frames, fps=8)
    return path


def main(init_dir: str = "checkpoints/ref", data_dir: str = "/data/badja_data",
         S: int = 8, stride: int = 4, iters: int = 6, max_iters: int = 7,
         resize_hw=(320, 512), dtype: str = "float32", out_dir: str = "",
         modeltype: str = "pips", raft_iters: int = 32, device: str = "cuda"):
    resolve_device(device)
    if modeltype == "pips":
        from pips_tpu_torch.evals.common import make_pips
        model = load_params(make_pips(S=S, stride=stride, dtype=dtype, device=device), init_dir)
        chain = ChainTracker(model, iters=iters, device=device)
        track = lambda xy0, rgbs: chain.track_video(rgbs, xy0)[0]  # noqa: E731
    else:
        from pips_tpu_torch.evals.common import build_baseline_tracker
        baseline = build_baseline_tracker(modeltype, init_dir, raft_iters=raft_iters,
                                          device=device)
        track = lambda xy0, rgbs: baseline(xy0[None], rgbs[None])[0]  # noqa: E731

    dataset = BadjaDataset(data_dir)
    results = {}
    for vid in range(min(max_iters, len(dataset))):
        d = dataset[vid]
        T, H, W, _ = d["rgbs"].shape
        H_, W_ = resize_hw
        sy, sx = H_ / H, W_ / W
        rgbs = resize_video_half_pixel(d["rgbs"], (H_, W_))
        segs = resize_video_nearest((d["segs"] > 0).astype(np.float32), (H_, W_))
        trajs_g = d["trajs"] * [sx, sy]
        vis = d["visibles"]

        t0 = time.time()
        trajs_e = track(trajs_g[0].astype(np.float32), rgbs)
        pck = pck_at_sqrt_area(trajs_e, trajs_g, vis, segs)
        results[d["name"]] = pck
        print(f"{d['name']}: pck {pck:.1f} ({time.time() - t0:.1f}s, T={T})")

        if out_dir:
            # colored-keypoints-on-gray overlay GIF (reference
            # test_on_badja.py:126-139 kp_vis block, incl. its
            # summ_soft_seg_thr rendering)
            write_kp_vis(out_dir, d["name"], rgbs, trajs_e)

    results["avg"] = float(np.mean([v for v in results.values()]))
    print("results", results)
    return results


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    print(auto_cli(main))
