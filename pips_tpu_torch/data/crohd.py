"""CroHD head-tracking dataset (counterpart of ``pips_tpu/data/crohd.py``;
capability parity: reference ``crohddataset.py:14-110``).

Parses MOT-format ``gt.txt`` into per-frame box/score/vis arrays; samples are
S-frame windows with box centers as xy targets. Channel-last numpy output.
Frames are decoded by ``data.pfm.read_image`` (PIL).
"""

from __future__ import annotations

import os

import numpy as np

from pips_tpu_torch.data import pfm

TRAIN_FOLDERS = ("HT21-01", "HT21-02", "HT21-03", "HT21-04")
VAL_FOLDERS = ("HT21-11", "HT21-12", "HT21-13", "HT21-14", "HT21-15")


def _imread(path: str) -> np.ndarray:
    return pfm.read_image(path)


class CrohdDataset:
    def __init__(self, seqlen: int = 8, dset: str = "t",
                 dataset_root: str = "../head_tracking"):
        split = "train" if dset == "t" else "val"
        if dset not in ("t", "v"):
            raise ValueError("dset must be 't' or 'v'")
        self.seqlen = seqlen
        self.dataset_location = os.path.join(dataset_root, "HT21", split)
        self.label_location = os.path.join(dataset_root, "HT21Labels", split)
        self.subfolders = TRAIN_FOLDERS if dset == "t" else VAL_FOLDERS

        self.folder_to_gt = {}
        self.subfolder_lens = []
        for sub in self.subfolders:
            labels = np.loadtxt(os.path.join(self.label_location, sub, "gt/gt.txt"),
                                delimiter=",")
            n_frames = int(labels[-1, 0])
            n_heads = int(labels[:, 1].max())
            self.subfolder_lens.append(n_frames // seqlen)

            boxlist = np.zeros((n_frames, n_heads, 4))
            scorelist = -np.ones((n_frames, n_heads))
            vislist = np.zeros((n_frames, n_heads))
            for row in labels:
                frame_id, head_id = int(row[0]) - 1, int(row[1]) - 1
                left, top, width, height = row[2:6]
                scorelist[frame_id, head_id] = 1
                vislist[frame_id, head_id] = row[8]
                boxlist[frame_id, head_id] = [left, top, left + width, top + height]
            self.folder_to_gt[sub] = {"boxlist": boxlist, "scorelist": scorelist,
                                      "vislist": vislist}

    def __len__(self) -> int:
        return sum(self.subfolder_lens)

    def __getitem__(self, index: int) -> dict:
        sub_id = 0
        while index >= self.subfolder_lens[sub_id]:
            index -= self.subfolder_lens[sub_id]
            sub_id += 1
        sub = self.subfolders[sub_id]
        start = index * self.seqlen
        S = self.seqlen

        gt = self.folder_to_gt[sub]
        boxlist = gt["boxlist"][start:start + S]
        scorelist = gt["scorelist"][start:start + S]
        vislist = gt["vislist"][start:start + S]

        rgbs = [
            _imread(os.path.join(self.dataset_location, sub, "img1",
                                 f"{start + i + 1:06d}.jpg"))
            for i in range(S)
        ]
        xylist = np.stack([boxlist[:, :, [0, 2]].mean(2),
                           boxlist[:, :, [1, 3]].mean(2)], axis=2)
        return {
            "rgbs": np.stack(rgbs).astype(np.float32),  # (S, H, W, 3)
            "boxlist": boxlist,                         # (S, N, 4)
            "xylist": xylist,                           # (S, N, 2)
            "scorelist": scorelist,                     # (S, N)
            "vislist": vislist,                         # (S, N)
        }


def prep_sample(sample: dict, N_max: int, S_stride: int = 3,
                req_occlusion: bool = False) -> tuple[dict | None, bool]:
    """CroHD eval filtering (reference ``test_on_crohd.py:24-62``):
    subsample every ``S_stride``-th frame (S=8 survives from 24), keep heads
    that are (a) present in all S frames, (b) moving — summed distance from
    the frame-0 position > 150px, (c) fully visible in the first two frames,
    and (d) occluded somewhere (sum of per-frame visibility < S) when
    ``req_occlusion`` else fully visible throughout (sum == S).
    Returns (dict with trajs_g/vis_g or None, ok).

    (The reference has a permute typo at ``test_on_crohd.py:25`` passing
    ``S_stride`` as a dim index — harmless there since S_stride==3 matches
    the intended dim; we implement the intended frame subsampling.)
    """
    rgbs = sample["rgbs"][::S_stride]
    xylist = sample["xylist"][::S_stride].astype(np.float32)
    scorelist = sample["scorelist"][::S_stride]
    vislist = sample["vislist"][::S_stride]
    S = rgbs.shape[0]

    seq_present = scorelist.sum(0) == S
    motion = np.sqrt(((xylist[1:] - xylist[:1]) ** 2).sum(2)).sum(0)  # (N,) dist from frame0
    seq_moving = motion > 150
    seq_vis_init = vislist[:2].sum(0) == 2
    seq_occlusion = vislist.sum(0) < S
    seq_visible = vislist.sum(0) == S
    keep = seq_present * seq_vis_init * seq_moving * \
        (seq_occlusion if req_occlusion else seq_visible)
    idx = np.where(keep > 0)[0]
    if len(idx) == 0:
        return None, False
    idx = idx[:N_max]

    return {
        "rgbs": rgbs[None],                           # (1, S, H, W, 3)
        "trajs_g": xylist[:, idx][None],              # (1, S, N, 2)
        "vis_g": vislist[:, idx][None].astype(np.float32),  # (1, S, N)
    }, True
