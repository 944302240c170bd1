"""DAVIS dense-grid throughput probe (counterpart of
``pips_tpu/evals/run_davis.py``; capability parity: reference
``test_on_davis.py``): 8 frames resized to 480x1024, query every 8th pixel,
track in chunks, print full_time / step time / TPS (the reference's own perf
metric, ``test_on_davis.py:126-129``). Runs on CUDA unless ``--device cpu``.

    python -m pips_tpu_torch.evals.run_davis --init_dir <ckpt> --davis_dir <davis>
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

from pips_tpu_torch.data.pfm import read_image
from pips_tpu_torch.evals.common import load_params, resize_video_half_pixel
from pips_tpu_torch.inference.window import WindowTracker, dense_queries
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.parallel.mesh import parse_mesh_arg


def main(init_dir: str = "checkpoints/ref", davis_dir: str = "/data/davis",
         S: int = 8, stride: int = 8, iters: int = 6, chunk: int = 256,
         resize_hw=(480, 1024), max_videos: int = 20, point_stride: int = 8,
         out_dir: str = "", dtype: str = "float32", mesh: str = "", device: str = "cuda"):
    """``--chunk 0`` tracks the whole dense grid in one call; points are
    independent, so nothing asks for chunks on the card other than memory
    (the reference's GPU workaround, ``test_on_davis.py:111``). chunk>0 keeps
    the reference-style loop, the last chunk padded to the chunk's size.

    ``--mesh auto`` (or ``--mesh D,P``) splits the query points over the
    processes of the group (``parallel.parse_mesh_arg``; launch one process
    a device, e.g. with ``torchrun``), each tracking its slice of every
    chunk; best combined with ``--chunk 0``. Every process returns all the
    points' results."""
    resolve_device(device)
    tracker_mesh = parse_mesh_arg(mesh, device)  # joins the group before the model is placed
    from pips_tpu_torch.evals.common import make_pips
    model = load_params(make_pips(S=S, stride=stride, dtype=dtype, device=device), init_dir)

    video_dirs = sorted(glob.glob(os.path.join(davis_dir, "JPEGImages/Full-Resolution/*")))
    if not video_dirs:
        raise FileNotFoundError(f"no DAVIS videos under {davis_dir}")

    tracker = WindowTracker(model, iters=iters, corr_mode="onehot", device=device,
                            mesh=tracker_mesh)

    H_, W_ = resize_hw
    all_tps = []
    last_trajs = None
    for vd in video_dirs[:max_videos]:
        frames = sorted(glob.glob(os.path.join(vd, "*.jpg")))[:S]
        if len(frames) < S:
            continue
        rgbs = np.stack([read_image(f) for f in frames]).astype(np.float32)
        rgbs = resize_video_half_pixel(rgbs, (H_, W_))[None]

        xy = dense_queries(H_, W_, stride=point_stride)[0]  # (H2*W2, 2)
        eff_chunk = chunk if chunk > 0 else len(xy)
        t0 = time.time()
        step_times = []
        trajs, viss = [], []
        for i0 in range(0, len(xy), eff_chunk):
            xy0 = xy[i0:i0 + eff_chunk]
            if len(xy0) < eff_chunk:  # pad to fixed shape
                xy0 = np.concatenate([xy0, np.repeat(xy0[-1:], eff_chunk - len(xy0), 0)])
            ts = time.time()
            tr, vi = tracker(xy0[None], rgbs)  # numpy out (forces completion)
            step_times.append(time.time() - ts)
            trajs.append(tr)
            viss.append(vi)
        full_time = time.time() - t0
        tps = len(xy) / full_time
        all_tps.append(tps)
        # the last video's dense trajectories (S, N, 2), for callers and tests;
        # also drawn into the GIF below
        last_trajs = np.concatenate(trajs, axis=2)[0, :, :len(xy)]
        print(f"{os.path.basename(vd)}: full_time {full_time:.2f}s; "
              f"step {np.mean(step_times):.3f}s; TPS {tps:.0f}")
        if out_dir:  # GIF dump (reference test_on_davis.py writes summaries)
            from pips_tpu_torch.utils.improc import draw_trajs_on_rgbs2, write_gif
            os.makedirs(out_dir, exist_ok=True)
            vis_np = 1.0 / (1.0 + np.exp(-np.concatenate(viss, axis=2)[0, :, :len(xy)]))
            sub = slice(0, None, 16)  # thin the dense grid for drawing
            frames = draw_trajs_on_rgbs2(
                np.clip(rgbs[0], 0, 255).astype(np.uint8),
                last_trajs[:, sub], vis_np[:, sub])
            write_gif(os.path.join(out_dir, f"{os.path.basename(vd)}.gif"),
                      list(frames), fps=8)
    if not all_tps:
        raise FileNotFoundError(
            f"no video under {davis_dir} has >= {S} frames")
    print(f"mean TPS over {len(all_tps)} videos: {np.mean(all_tps):.0f}")
    return {"mean_tps": float(np.mean(all_tps)), "trajs": last_trajs}


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    print(auto_cli(main))
