"""Single-window demo (counterpart of ``examples/demo.py``; capability parity:
reference ``demo.py``).

Reads jpg frames, resizes them to 360x640, tracks a 16x16 query grid through
each S-frame chunk in one window, writes one trajectory GIF a chunk. Runs on
CUDA unless ``--device cpu``; ``--bf16 true`` runs the bf16 model with the
fused channel-block kernel.

    python -m pips_tpu_torch.demo --init_dir <ckpt> --images_dir ./demo_images
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

from pips_tpu_torch.data.pfm import read_image
from pips_tpu_torch.evals.common import load_params, resize_video_half_pixel
from pips_tpu_torch.inference.window import WindowTracker, grid_queries
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.utils.improc import draw_trajs_on_rgbs, write_gif


def main(init_dir: str = "checkpoints/ref", images_dir: str = "./demo_images",
         out_dir: str = "./demo_out", S: int = 8, stride: int = 4, iters: int = 6,
         resize_hw=(360, 640), grid: int = 16, max_chunks: int = 0,
         bf16: bool = False, device: str = "cuda") -> dict:
    """Track and draw every chunk; returns {"trajs": [(S, N, 2) a chunk],
    "gifs": [paths], "seconds": [a chunk's window]}. The weights come from
    ``evals.common.load_params`` (the port's, the JAX package's or the
    reference's checkpoints, or ``random``)."""
    resolve_device(device)
    filenames = sorted(glob.glob(os.path.join(images_dir, "*.jpg")))
    if not filenames:
        raise FileNotFoundError(f"no jpgs in {images_dir}")
    print(f"found {len(filenames)} frames")

    from pips_tpu_torch.evals.common import make_pips
    model = make_pips(S=S, stride=stride, dtype="bfloat16" if bf16 else "float32",
                      device=device)
    tracker = WindowTracker(load_params(model, init_dir), iters=iters, device=device)

    H_, W_ = resize_hw
    xys = grid_queries(H_, W_, grid, grid)  # (1, grid*grid, 2)

    os.makedirs(out_dir, exist_ok=True)
    n_chunks = len(filenames) // S
    if max_chunks:
        n_chunks = min(n_chunks, max_chunks)
    out = {"trajs": [], "gifs": [], "seconds": []}
    for ci in range(n_chunks):
        frames = [read_image(f) for f in filenames[ci * S:(ci + 1) * S]]
        rgbs = resize_video_half_pixel(np.stack(frames).astype(np.float32), (H_, W_))

        t0 = time.time()
        trajs, _ = tracker(xys, rgbs[None])
        secs = time.time() - t0
        print(f"chunk {ci}: {secs:.2f}s")

        vis_frames = draw_trajs_on_rgbs(rgbs.astype(np.uint8), trajs[0],
                                        cmap="spring", linewidth=2)
        out_fn = os.path.join(out_dir, f"demo_chunk{ci:03d}.gif")
        write_gif(out_fn, list(vis_frames), fps=8)
        print(f"saved {out_fn}")
        out["trajs"].append(trajs[0])
        out["gifs"].append(out_fn)
        out["seconds"].append(secs)
    return out


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    auto_cli(main)
