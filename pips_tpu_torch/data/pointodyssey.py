"""PointOdyssey dataset (counterpart of ``pips_tpu/data/pointodyssey.py``;
capability parity: reference ``pointodysseydataset.py:20-369``).

Per clip: S consecutive jpg frames + slices of ``annotations.npz``
(trajs_2d, visibilities==1), visibility-at-frame0 and >=3-visible filters,
farthest-point subsampling when over-full, zero-padding + valids. The
reference's aug path asserts False (``pointodysseydataset.py:131``) — we route
through the shared aug stack instead when requested. Frames are decoded by
``data.pfm.read_image`` (PIL).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from pips_tpu_torch.data import pfm
from pips_tpu_torch.data.augs import just_crop, photometric_augs, spatial_augs
from pips_tpu_torch.ops.fps import farthest_point_sample_py


class PointOdysseyDataset:
    def __init__(self, dataset_location: str = "/data/point_odyssey",
                 dset: str = "train", use_augs: bool = False, S: int = 8,
                 N: int = 32, crop_size=(368, 496), seed: int = 125):
        self.S, self.N = S, N
        self.use_augs = use_augs
        self.crop_size = tuple(crop_size)
        self.seed = seed

        split_dir = {"train": "train", "TRAIN": "train", "val": "val", "VAL": "val",
                     "test": "test_clean", "TEST": "test_clean"}[dset]
        self.clips = []  # (rgb_paths, annotations_path, start)
        for seq in sorted(glob.glob(os.path.join(dataset_location, split_dir, "*"))):
            rgb_dir = os.path.join(seq, "rgbs")
            if not os.path.isdir(rgb_dir):
                continue
            n_frames = len(os.listdir(rgb_dir))
            ann = os.path.join(seq, "annotations.npz")
            for ii in range(n_frames - S):
                paths = [os.path.join(rgb_dir, f"rgb_{ii + jj + 1:05d}.jpg")
                         for jj in range(S)]
                self.clips.append((paths, ann, ii))
        print(f"collected {len(self.clips)} clips of length {S} in "
              f"{dataset_location} (dset={dset})")

    def __len__(self) -> int:
        return len(self.clips)

    def getitem_helper(self, index: int):
        # virtual-index protocol (see flyingthings.getitem_helper): sample
        # selection wraps, augs re-randomize with the epoch component.
        rgb_paths, ann_path, start = self.clips[index % len(self.clips)]
        rng = np.random.RandomState((self.seed + index * 104729) % (1 << 31))

        ann = np.load(ann_path, allow_pickle=True)
        idx = start + np.arange(self.S)
        trajs = ann["trajs_2d"][idx].astype(np.float32)
        visibs = (ann["visibilities"][idx] == 1).astype(np.float32)
        S, N, D = trajs.shape
        assert D == 2 and S == self.S
        if N < self.N:
            return None, False

        rgbs = [pfm.read_image(p)[:, :, :3] for p in rgb_paths]

        H, W = rgbs[0].shape[:2]
        dummy_occs = [np.zeros((H, W), np.float32) for _ in rgbs]
        dummy_masks = [np.zeros((H, W), np.float32) for _ in rgbs]
        if self.use_augs:
            rgbs, trajs, visibs = photometric_augs(rgbs, trajs, visibs, rng,
                                                   color_prob=0.5, blur_prob=0.2)
            rgbs, _, _, trajs = spatial_augs(rgbs, dummy_occs, dummy_masks, trajs,
                                             visibs, rng, self.crop_size)
        else:
            rgbs, _, _, trajs = just_crop(rgbs, dummy_occs, dummy_masks, trajs,
                                          rng, self.crop_size)

        H, W = rgbs[0].shape[:2]
        for s in range(S):  # avoid the 1px edge
            oob = (trajs[s, :, 0] < 1) | (trajs[s, :, 0] > W - 2) \
                | (trajs[s, :, 1] < 1) | (trajs[s, :, 1] > H - 2)
            visibs[s, oob] = 0

        keep = visibs[0] > 0
        trajs, visibs = trajs[:, keep], visibs[:, keep]
        keep = visibs.sum(axis=0) >= 3
        trajs, visibs = trajs[:, keep], visibs[:, keep]

        N = trajs.shape[1]
        if N == 0:
            return None, False
        N_ = min(N, self.N)
        if N > self.N:
            inds = farthest_point_sample_py(trajs[0], N_, rng)
        else:
            inds = rng.choice(N, N_, replace=False)

        trajs_full = np.zeros((self.S, self.N, 2), np.float32)
        visibs_full = np.zeros((self.S, self.N), np.float32)
        valids_full = np.zeros((self.S, self.N), np.float32)
        trajs_full[:, :N_] = trajs[:, inds]
        visibs_full[:, :N_] = visibs[:, inds]
        valids_full[:, :N_] = 1.0

        sample = {
            "rgbs": np.stack(rgbs).astype(np.float32),
            "trajs": trajs_full,
            "visibles": visibs_full,
            "valids": valids_full,
        }
        return sample, True

    def __getitem__(self, index: int):
        try:
            sample, gotit = self.getitem_helper(index)
        except (OSError, ValueError, KeyError) as e:
            print(f"warning: sample {index} failed to load: {e}")
            sample, gotit = None, False
        if not gotit:
            H, W = self.crop_size
            sample = {
                "rgbs": np.zeros((self.S, H, W, 3), np.float32),
                "trajs": np.zeros((self.S, self.N, 2), np.float32),
                "visibles": np.zeros((self.S, self.N), np.float32),
                "valids": np.zeros((self.S, self.N), np.float32),
            }
        return sample, gotit
