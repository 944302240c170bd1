"""Offline dataset-generation runs (counterpart of
``pips_tpu/datagen/run.py``): walk the FlyingThings tree and emit
``trajs_at_<k>.npz`` / ``occluder_at_<k>.npy`` (reference ``make_trajs.py:go``,
``make_occlusions.py:go``).

    python -m pips_tpu_torch.datagen.run --what trajs --flt3d_path <flyingthings>
    python -m pips_tpu_torch.datagen.run --what occluders --flt3d_path <flyingthings>
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from pips_tpu_torch.data.pfm import read_image_or_pfm, read_pfm
from pips_tpu_torch.datagen.occluders import extract_occluders_for_clip
from pips_tpu_torch.datagen.trajs import make_trajs_for_clip

MIN_LIFESPAN = 8


def _read_clip(rgb_dir: str, mask_dir: str, flow_dir: str, lr: str, start: int):
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(rgb_dir, "*")))
    if len(names) < start + MIN_LIFESPAN:  # camera/clip missing or too short
        return None
    suffix = "L" if lr == "left" else "R"
    masks, flows_f, flows_b = [], [], []
    for name in names:
        masks.append(read_image_or_pfm(os.path.join(mask_dir, name + ".pfm")))
        try:
            flows_f.append(read_pfm(os.path.join(
                flow_dir, "into_future", lr,
                f"OpticalFlowIntoFuture_{name}_{suffix}.pfm"))[:, :, :2])
            flows_b.append(read_pfm(os.path.join(
                flow_dir, "into_past", lr,
                f"OpticalFlowIntoPast_{name}_{suffix}.pfm"))[:, :, :2])
        except FileNotFoundError:
            return None
    S = MIN_LIFESPAN
    masks = np.stack(masks[start:start + S]).astype(np.float32)
    ff = np.stack(flows_f[start:start + S - 1]).astype(np.float32)
    fb = np.stack(flows_b[start + 1:start + S]).astype(np.float32)
    return masks, ff, fb


def main(what: str = "trajs", flt3d_path: str = "/data/flyingthings",
         dsets=("TRAIN", "TEST"), subsets=("A", "B", "C"), mod: str = "ad",
         occ_mod: str = "al", starts=(0, 1, 2)):
    for dset in dsets:
        for subset in subsets:
            rgb_root = os.path.join(flt3d_path, "frames_cleanpass_webp", dset, subset)
            flow_root = os.path.join(flt3d_path, "optical_flow", dset, subset)
            mask_root = os.path.join(flt3d_path, "object_index", dset, subset)
            tag = f"trajs_{mod}" if what == "trajs" else f"occluders_{occ_mod}"
            out_root = os.path.join(flt3d_path, tag, dset, subset)
            folders = sorted(os.path.basename(p)
                             for p in glob.glob(os.path.join(rgb_root, "*")))
            for folder in folders:
                for lr in ("left", "right"):
                    for start in starts:
                        out_dir = os.path.join(out_root, folder, lr)
                        suffix = ("trajs_at_%d.npz" if what == "trajs"
                                  else "occluder_at_%d.npy") % start
                        out_f = os.path.join(out_dir, suffix)
                        if os.path.isfile(out_f):
                            sys.stdout.write(":")
                            continue
                        clip = _read_clip(os.path.join(rgb_root, folder, lr),
                                          os.path.join(mask_root, folder, lr),
                                          os.path.join(flow_root, folder), lr, start)
                        if clip is None:
                            sys.stdout.write("!")
                            continue
                        masks, ff, fb = clip
                        os.makedirs(out_dir, exist_ok=True)
                        if what == "trajs":
                            trajs = make_trajs_for_clip(ff, fb, masks)
                            np.savez(out_f, trajs=trajs)
                        else:
                            np.save(out_f, extract_occluders_for_clip(masks, ff, fb))
                        sys.stdout.write(".")
                        sys.stdout.flush()
            print(f"\ndone {dset}/{subset}")


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    auto_cli(main)
