"""Long-video chaining demo (counterpart of ``examples/chain_demo.py``;
capability parity: reference ``chain_demo.py``).

Tracks query points (``x0``/``y0`` repeated ``N`` times, or a ``grid`` x
``grid`` grid) through an arbitrarily long jpg sequence by visibility-aware
window chaining, batched across points (``inference.chain``), and writes one
GIF over the whole video. ``--on_device`` keeps the chaining state on the
device (``ChainTrackerOnDevice``); ``--stream`` decodes the jpgs on a
background thread (``FrameFeed``) while windows refine (``track_stream``).
Runs on CUDA unless ``--device cpu``; ``--bf16 true`` runs the bf16 model
with the fused channel-block kernel.

    python -m pips_tpu_torch.chain_demo --init_dir <ckpt> --images_dir ./demo_images
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

from pips_tpu_torch.data.pfm import read_image
from pips_tpu_torch.evals.common import load_params, resize_video_half_pixel
from pips_tpu_torch.inference import ChainTracker, ChainTrackerOnDevice, FrameFeed
from pips_tpu_torch.inference.window import grid_queries
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.utils.improc import draw_trajs_on_rgbs, write_gif


def main(init_dir: str = "checkpoints/ref", images_dir: str = "./demo_images",
         out_dir: str = "./chain_out", S: int = 8, stride: int = 4, iters: int = 6,
         resize_hw=(360, 640), x0: float = 450.0, y0: float = 100.0, N: int = 1,
         grid: int = 0, max_frames: int = 0, on_device: bool = False,
         bf16: bool = False, stream: bool = False, device: str = "cuda") -> dict:
    """Chain the points through the video and draw them; returns {"trajs"
    (T, N, 2), "vis" (T, N), "gif": path, "seconds": the tracking's}."""
    resolve_device(device)
    filenames = sorted(glob.glob(os.path.join(images_dir, "*.jpg")))
    if max_frames:
        filenames = filenames[:max_frames]
    if not filenames:
        raise FileNotFoundError(f"no jpgs in {images_dir}")
    T = len(filenames)
    print(f"tracking through {T} frames")

    H_, W_ = resize_hw

    def _decode(fn):
        return resize_video_half_pixel(read_image(fn)[None].astype(np.float32), (H_, W_))[0]

    rgbs = None
    if stream:
        # double-buffered feed: jpg decode and resize on a background thread
        # overlap the device's encode; the GIF decodes the frames again
        video_in = FrameFeed([(lambda f=f: _decode(f)) for f in filenames], chunk=S, depth=2)
    else:
        rgbs = np.stack([read_image(f) for f in filenames]).astype(np.float32)
        rgbs = resize_video_half_pixel(rgbs, (H_, W_))
        video_in = rgbs

    if grid:
        xys = grid_queries(H_, W_, grid, grid)[0]
    else:
        xys = np.tile(np.array([[x0, y0]], np.float32), (N, 1))

    from pips_tpu_torch.evals.common import make_pips
    model = load_params(make_pips(S=S, stride=stride, dtype="bfloat16" if bf16 else "float32",
                                  device=device), init_dir)
    if on_device:
        chain = ChainTrackerOnDevice(model, iters=iters, device=device)
    else:
        chain = ChainTracker(model, iters=iters, device=device)

    t0 = time.time()
    if stream and not on_device:
        # fully online: windows refine as frames decode and encode, features
        # behind the earliest pending window are evicted (bounded memory)
        trajs, vis = chain.track_stream(video_in, xys.astype(np.float32))
    else:
        trajs, vis = chain.track_video(video_in, xys.astype(np.float32))
    dt = time.time() - t0
    tag = " (decode streamed)" if stream else ""
    print(f"chained {len(xys)} points x {T} frames in {dt:.2f}s "
          f"({len(xys) * T / dt:.0f} points*frames/sec){tag}")

    if rgbs is None:
        rgbs = np.stack([_decode(f) for f in filenames])
    gray = np.mean(rgbs, axis=-1, keepdims=True).repeat(3, -1).astype(np.uint8)
    vis_frames = draw_trajs_on_rgbs(gray, trajs, visibles=vis, cmap="spring", linewidth=2)
    os.makedirs(out_dir, exist_ok=True)
    out_fn = os.path.join(out_dir, "chain_out.gif")
    write_gif(out_fn, list(vis_frames), fps=12)
    print(f"saved {out_fn}")
    return {"trajs": trajs, "vis": vis, "gif": out_fn, "seconds": dt}


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    auto_cli(main)
