"""BADJA animal keypoint dataset (counterpart of ``pips_tpu/data/badja.py``;
capability parity: reference ``badjadataset.py:131-343``).

Per video: DAVIS frames + segmentations + SMAL joint annotations (subset of
annotated classes), with missing-annotation frames zero-filled and the
(y, x) -> (x, y) coordinate flip applied. Output is channel-last numpy.
Frames are decoded by ``data.pfm.read_image`` (PIL), and a segmentation of
another size than its frame is resized as cv2's INTER_NEAREST does.
"""

from __future__ import annotations

import json
import os
import numpy as np

from pips_tpu_torch.data import pfm
from pips_tpu_torch.data.augs import resize_nearest

# SMAL joint ids that carry annotations (reference ``badjadataset.py:81-90``)
ANNOTATED_CLASSES = np.array([
    8, 9, 10,      # upper_right
    12, 13, 14,    # upper_left
    15,            # neck
    18, 19, 20,    # lower_right
    22, 23, 24,    # lower_left
    25, 28, 31,    # tail
    32, 33,        # head (jaw, nose)
    35,            # right_ear
    36,            # left_ear
])

IGNORE_ANIMALS = ("cat_jump.json", "tiger.json")

# Body-region color per annotated joint (reference ``badjadataset.py:91-128``:
# joints group into regions, each region has a display color; used by the
# keypoint-overlay vis in run_badja)
_REGION_COLORS = np.array([
    [60, 180, 75],     # upper_right, green
    [230, 25, 75],     # upper_left, red
    [128, 0, 0],       # neck, maroon
    [0, 130, 200],     # lower_right, blue
    [255, 255, 25],    # lower_left, yellow
    [240, 50, 230],    # tail, magenta
    [245, 130, 48],    # head (jaw/nose), orange
    [29, 98, 115],     # right_ear, turquoise
    [255, 153, 204],   # left_ear, pink
], np.uint8)
_JOINT_REGION = np.array([0, 0, 0, 1, 1, 1, 2, 3, 3, 3, 4, 4, 4,
                          5, 5, 5, 6, 6, 7, 8])
JOINT_COLORS = _REGION_COLORS[_JOINT_REGION]  # (20, 3) uint8


def _imread(path: str) -> np.ndarray:
    return pfm.read_image(path)


class BadjaDataset:
    def __init__(self, data_root: str = "../badja"):
        self.data_root = data_root
        annotations_path = os.path.join(data_root, "joint_annotations")
        self.videos = []  # (filenames, segnames, joints, visibles)

        for animal_json in sorted(os.listdir(annotations_path)):
            if animal_json in IGNORE_ANIMALS:
                continue
            with open(os.path.join(annotations_path, animal_json)) as f:
                ann = json.load(f)
            first_path = ann[0]["segmentation_path"]
            if "extra_videos" in first_path:
                continue
            animal = first_path.split("/")[-2]
            first_frame = int(os.path.basename(first_path).split(".")[0])
            last_frame = int(os.path.basename(ann[-1]["segmentation_path"]).split(".")[0])

            by_image = {os.path.join(data_root, a["image_path"]): a for a in ann}
            filenames, segnames, joints, visibles = [], [], [], []
            for fr in range(first_frame, last_frame + 1):
                fn = os.path.join(data_root,
                                  f"DAVIS/JPEGImages/Full-Resolution/{animal}/{fr:05d}.jpg")
                sn = os.path.join(data_root,
                                  f"DAVIS/Annotations/Full-Resolution/{animal}/{fr:05d}.png")
                a = by_image.get(fn)
                filenames.append(fn)
                segnames.append(sn)
                joints.append(np.array(a["joints"]) if a else None)
                visibles.append(np.array(a["visibility"]) if a else None)
            if filenames:
                self.videos.append((animal, filenames, segnames, joints, visibles))
        print(f"found {len(self.videos)} unique videos in {data_root}")

    def __len__(self) -> int:
        return len(self.videos)

    def video_name(self, index: int) -> str:
        return self.videos[index][0]

    def __getitem__(self, index: int) -> dict:
        animal, filenames, segnames, joints, visibles = self.videos[index]
        S = len(filenames)

        rgbs, segs = [], []
        for s in range(S):
            rgb = _imread(filenames[s])
            H, W = rgb.shape[:2]
            seg = _imread(segnames[s])
            if seg.shape[:2] != (H, W):
                seg = resize_nearest(seg, (H, W))
            if seg.ndim == 3:
                seg = seg[:, :, 0]
            rgbs.append(rgb)
            segs.append(seg)

        N = len(ANNOTATED_CLASSES)
        trajs = np.zeros((S, N, 2), np.float32)
        vis = np.zeros((S, N), np.float32)
        for s in range(S):
            if joints[s] is not None:
                j = np.asarray(joints[s])[ANNOTATED_CLASSES]
                trajs[s] = j[:, ::-1]  # stored (y, x) -> (x, y)
                vis[s] = np.asarray(visibles[s])[ANNOTATED_CLASSES]

        return {
            "file0": filenames[0],
            "name": animal,
            "rgbs": np.stack(rgbs).astype(np.float32),   # (S, H, W, 3)
            "segs": np.stack(segs).astype(np.float32),   # (S, H, W)
            "trajs": trajs,                              # (S, N, 2) xy
            "visibles": vis,                             # (S, N)
        }
