"""FlyingThings++ training/eval dataset (counterpart of
``pips_tpu/data/flyingthings.py``).

Capability parity with reference ``flyingthingsdataset.py:75-873``:
  * index scan over ``trajs_<version>/<dset>/<subset>/**/trajs_at_k.npz``
    (skipping near-empty files) and the matching occluder index;
  * per sample: webp frames + pfm object-index masks + precomputed
    trajectories; paste up to 12 cut-out occluders from other videos (with
    their own trajectories joining the pool, and covered points marked
    invisible); photometric + spatial augs (or just_crop);
  * visibility bookkeeping: occ==255 padding and out-of-bounds kill
    visibility; twice-visible filter (visible at frame 0 + one other frame,
    in-bounds likewise); random subsample to N with zero-padding + valids;
  * (sample, gotit) protocol with a fixed-shape fake sample on failure.

Output is channel-last numpy: rgbs (S, H, W, 3) float32 0..255,
occs/masks (S, H, W), trajs (S, N, 2), visibles/valids (S, N).

Frames are decoded by ``data.pfm.read_image`` (PIL); the occluders' mask
blur is a numpy form of cv2's 3x3 Gaussian, and the point bookkeeping runs
in the port's host library.
"""

from __future__ import annotations

import functools
import glob
import os
import numpy as np

from pips_tpu_torch.data import pfm
from pips_tpu_torch.data.augs import (color_jitter, gaussian_blur, just_crop,
                                      photometric_augs, spatial_augs)
from pips_tpu_torch.data.pfm import read_image_or_pfm
from pips_tpu_torch.native import lib as native


def _load_webp(path: str) -> np.ndarray:
    return pfm.read_image(path)


def _blur_mask3(m: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(m, (3, 3), 0)`` on an f32 mask: taps (1/4, 1/2, 1/4)
    along rows, then columns, BORDER_REFLECT_101 (exact for the 0/1 masks it
    blurs: every partial sum is a multiple of 1/16)."""
    H, W = m.shape
    q, h = np.float32(0.25), np.float32(0.5)
    xl, xr = native.reflect101(W, W, -1), native.reflect101(W, W, 1)
    rows = m * h + (m[:, xl] + m[:, xr]) * q
    yu, yd = native.reflect101(H, H, -1), native.reflect101(H, H, 1)
    return rows * h + (rows[yu] + rows[yd]) * q


# ---- decoded-frame caches -------------------------------------------------
# The occluder protocol redraws source frames from a shared pool: every
# sample decodes up to max_occluders * S webp frames and pfm masks from
# OTHER videos (measured 104 decodes/sample, ~10 s/sample of pure decode on
# this box). Decoded frames are immutable inputs, so a process-wide LRU
# (shared by all loader threads) turns the redraws into hits. Arrays are
# marked read-only — consumers must copy before mutating (they already do:
# every downstream op is astype/arith/concat). Size is tunable via
# PIPS_FRAME_CACHE (entries per cache; ~0.6-0.8 MB/entry at 540x960).

_FRAME_CACHE_SIZE = int(os.environ.get("PIPS_FRAME_CACHE", "384"))


def _read_only(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=_FRAME_CACHE_SIZE)
def _load_webp_cached(path: str) -> np.ndarray:
    return _read_only(_load_webp(path))


@functools.lru_cache(maxsize=_FRAME_CACHE_SIZE)
def _load_mask_cached(path: str) -> np.ndarray:
    return _read_only(np.asarray(read_image_or_pfm(path)))


@functools.lru_cache(maxsize=_FRAME_CACHE_SIZE)
def _load_occ_info_cached(path: str) -> dict:
    """Occluder trajectory dict {id_str: (S, n, 2) float32}; occluders are
    redrawn from a shared pool, so the np.load+unpickle runs once per file."""
    info = np.load(path, allow_pickle=True).item()
    return {k: _read_only(np.asarray(v, np.float32)) for k, v in info.items()}


@functools.lru_cache(maxsize=_FRAME_CACHE_SIZE)
def _load_id_mask_cached(path: str, occ_id: int):
    """(bool mask, (y0, y1, x0, x1) or None): one object's support in one
    frame. The full-frame ``== id`` compare and bbox scan run once per
    (frame, id) — occluder redraws across samples hit the cache."""
    m = _load_mask_cached(path) == occ_id
    rows = m.any(axis=1)
    if not rows.any():
        return _read_only(m), None
    cols = m.any(axis=0)
    y0 = int(rows.argmax())
    y1 = int(len(rows) - rows[::-1].argmax())
    x0 = int(cols.argmax())
    x1 = int(len(cols) - cols[::-1].argmax())
    return _read_only(m), (y0, y1, x0, x1)


def _mark_covered_by_later_layers(painter, trajs, birth, visibles):
    """Deferred occluder visibility marking, one vectorized pass.

    ``painter[s]`` is a uint8 raster holding, per pixel, the index (1-based
    paste order) of the LAST occluder whose support mask covered it in frame
    ``s``; ``birth[n]`` is the layer point ``n`` arrived with (0 = base
    points). A point is covered exactly by the occluders pasted AFTER its
    own layer whose support contains its (rounded, in-bounds) pixel — and
    since later pastes overwrite earlier ones, the raster holds the max
    layer, so ``painter > birth`` decides. Replays the reference's
    per-occluder marking (``flyingthingsdataset.py:568-579``) without the
    O(occluders * S * N) rescans of the growing point pool.
    """
    for s in range(len(painter)):
        native.mark_covered_frame(painter[s], trajs[s], birth, visibles[s])
    return visibles


def visibility_filter(trajs, visibles, valids, occs, crop_size, *,
                      force_twice_vis=True, force_last_vis=False,
                      force_all_inb=False):
    """Post-aug visibility bookkeeping + trajectory filters
    (reference ``flyingthingsdataset.py:314-432`` semantics):

      * a point on an occ==255 padding pixel (rounded coords, in-bounds)
        or out of bounds (unrounded coords) becomes invisible;
      * twice-visible filter: keep points visible at frame 0 AND >=1 other
        frame, in-bounds likewise (the two "other" frames may differ);
      * optional last-visible / all-in-bounds filters.

    One vectorized pass over (S, N) — N runs ~1e5 pre-subsample (base
    points plus every pasted occluder's own trajectories), so per-frame
    python loops dominate a sample's load time here.
    """
    S = len(occs)
    H, W = crop_size
    # per-frame fused pass (the host library): a point on an occ==255
    # padding pixel (rounded coords, in-bounds) or out of bounds in float
    # coords (the reference's oob test is unrounded) becomes invisible;
    # also yields the float in-bounds mask the filters below consume
    trajs = np.ascontiguousarray(trajs, np.float32)
    visibles = np.array(visibles, np.float32)  # owned copy, mutated below
    inb_u8 = np.empty((S, trajs.shape[1]), np.uint8)
    for s in range(S):
        native.visibility_frame(trajs[s],
                                np.ascontiguousarray(occs[s], np.float32),
                                visibles[s], inb_u8[s])
    inb_f = inb_u8.view(np.bool_)

    if force_twice_vis:
        vis = visibles > 0
        keep = (inb_f[0] & inb_f[1:].any(axis=0)
                & vis[0] & vis[1:].any(axis=0))
        trajs, visibles, valids = trajs[:, keep], visibles[:, keep], valids[:, keep]
        inb_f = inb_f[:, keep]

    if force_last_vis:
        keep = (visibles[-1] > 0) & inb_f[-1]
        trajs, visibles, valids = trajs[:, keep], visibles[:, keep], valids[:, keep]
        inb_f = inb_f[:, keep]

    if force_all_inb:
        keep = inb_f.all(axis=0)
        trajs, visibles, valids = trajs[:, keep], visibles[:, keep], valids[:, keep]
    return trajs, visibles, valids


class FlyingThingsDataset:
    def __init__(self, dataset_location: str = "../flyingthings", dset: str = "TRAIN",
                 subset: str = "all", use_augs: bool = False, N: int = 0,
                 S_load: int = 8, S: int = 8, crop_size=(368, 496),
                 version: str = "ad", occ_version: str = "al",
                 force_twice_vis: bool = True, force_last_vis: bool = False,
                 force_all_inb: bool = False, max_occluders: int = 12,
                 seed: int = 125):
        self.S_load, self.S, self.N = S_load, S, N
        self.use_augs = use_augs
        self.crop_size = tuple(crop_size)
        self.force_twice_vis = force_twice_vis
        self.force_last_vis = force_last_vis
        self.force_all_inb = force_all_inb
        self.max_occluders = max_occluders
        self.seed = seed

        subsets = ["A", "B", "C"] if subset == "all" else [subset]

        self.samples = []  # (rgb_dir, traj_dir, mask_dir, start_ind)
        self.occluders = []  # (rgb_dir, mask_dir, start_ind, occ_file)
        for sub in subsets:
            rgb_root = os.path.join(dataset_location, "frames_cleanpass_webp", dset, sub)
            traj_root = os.path.join(dataset_location, f"trajs_{version}", dset, sub)
            mask_root = os.path.join(dataset_location, "object_index", dset, sub)
            occ_root = os.path.join(dataset_location, f"occluders_{occ_version}", dset, sub)

            for folder in sorted(glob.glob(os.path.join(traj_root, "*"))):
                name = os.path.basename(folder)
                for lr in ["left", "right"]:
                    for start_ind in range(4):
                        fn = os.path.join(traj_root, name, lr, f"trajs_at_{start_ind}.npz")
                        if os.path.isfile(fn) and os.path.getsize(fn) > 1000:
                            self.samples.append((os.path.join(rgb_root, name, lr),
                                                 os.path.join(traj_root, name, lr),
                                                 os.path.join(mask_root, name, lr),
                                                 start_ind))
            for folder in sorted(glob.glob(os.path.join(occ_root, "*"))):
                name = os.path.basename(folder)
                for lr in ["left", "right"]:
                    for start_ind in range(3):
                        fn = os.path.join(occ_root, name, lr, f"occluder_at_{start_ind}.npy")
                        if os.path.isfile(fn) and os.path.getsize(fn) > 1000:
                            self.occluders.append((os.path.join(rgb_root, name, lr),
                                                   os.path.join(mask_root, name, lr),
                                                   start_ind, fn))
        print(f"found {len(self.samples)} samples and {len(self.occluders)} occluders "
              f"in {dataset_location} (dset={dset}, subset={subset}, version={version})")

    def __len__(self) -> int:
        return len(self.samples)

    def _frame_names(self, rgb_dir: str, start_ind: int) -> list[str]:
        names = sorted(os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(rgb_dir, "*")))
        return names[start_ind:start_ind + self.S_load]

    def _add_occluders(self, rgbs, masks, trajs, visibles, valids,
                       rng: np.random.RandomState):
        """Paste cut-out objects from other videos (``flyingthingsdataset.py:454-593``).

        Host-throughput design: source frames/masks come from the shared LRU
        caches, and ALL per-pixel work (mask blur, photometric jitter,
        compositing) runs on each frame's OWN support bounding box — an
        occluder typically covers a few percent of the frame, and a moving
        one's union-across-frames box can span most of it (the full-frame
        version measured ~7 s/sample of pure pasting; the union-box one
        ~0.5 s). Compositing stays uint8 (per-paste rounding instead of one
        final truncation: ±1 LSB where pastes overlap). Jitter statistics
        (contrast/saturation anchors) are bbox-local rather than
        full-frame; the jitter parameters are random draws, so the
        augmentation distribution is unchanged in spirit (documented
        deviation).
        """
        S = len(rgbs)
        H, W = rgbs[0].shape[:2]
        rgbs = [np.array(r, np.uint8) for r in rgbs]  # owned, mutated in place
        occs = [np.zeros((H, W), np.float32) for _ in rgbs]

        if self.occluders:
            # Visibility marking is DEFERRED: each paste paints its 1-based
            # layer index into a per-frame raster, and covered points are
            # resolved in one vectorized pass at the end
            # (_mark_covered_by_later_layers). Rescanning the growing point
            # pool per paste — each occluder clip carries ~8k points of its
            # own — was the pasting hot spot, not the pixels.
            pdt = np.uint8 if self.max_occluders < 256 else np.uint16
            painter = [np.zeros((H, W), pdt) for _ in range(S)]
            traj_parts = [trajs]
            birth_parts = [np.zeros(trajs.shape[1], np.int32)]
            layer = 0

            n_occ = min(self.max_occluders, len(self.occluders))
            alt_inds = rng.choice(len(self.occluders), n_occ, replace=False)
            for alt_ind in alt_inds:
                occ_rgb_dir, occ_mask_dir, occ_start, occ_fn = self.occluders[alt_ind]
                # truncate occluder clips to the (possibly subsampled) S;
                # skip clips too short to cover the window (indexing
                # masks_boxes[s] for s in range(S) would IndexError past
                # __getitem__'s error protocol otherwise)
                img_names = self._frame_names(occ_rgb_dir, occ_start)[:S]
                if len(img_names) < S:
                    continue
                occ_info = _load_occ_info_cached(occ_fn)
                id_str = list(occ_info.keys())[rng.choice(len(occ_info))]
                alt_trajs = occ_info[id_str][:S]
                if alt_trajs.shape[0] < S:  # clip shorter than the window
                    continue
                occ_id = int(id_str)

                masks_boxes = [
                    _load_id_mask_cached(
                        os.path.join(occ_mask_dir, n + ".pfm"), occ_id)
                    for n in img_names]
                if all(b is None for _, b in masks_boxes):
                    continue
                pad = 2  # blur halo
                boxes = [None if b is None else
                         (max(b[0] - pad, 0), min(b[1] + pad, H),
                          max(b[2] - pad, 0), min(b[3] + pad, W))
                         for _, b in masks_boxes]

                sub_rgbs = [
                    None if bx is None else
                    np.array(_load_webp_cached(
                        os.path.join(occ_rgb_dir, n + ".webp"))
                        [bx[0]:bx[1], bx[2]:bx[3]])
                    for n, bx in zip(img_names, boxes)]
                # photometric stack on the crops (same draw protocol as
                # photometric_augs with eraser/replace off)
                if rng.rand() < 0.5:
                    sub_rgbs = [None if r is None else color_jitter(r, rng)
                                for r in sub_rgbs]
                if rng.rand() < 0.5:
                    sub_rgbs = [None if r is None else gaussian_blur(r, rng)
                                for r in sub_rgbs]

                layer += 1
                for s in range(S):
                    if boxes[s] is None:
                        continue
                    y0, y1, x0, x1 = boxes[s]
                    m = masks_boxes[s][0][y0:y1, x0:x1]
                    mf = m.astype(np.float32)
                    mb = np.clip(_blur_mask3(mf), 0, 1)[..., None]
                    reg = rgbs[s][y0:y1, x0:x1].astype(np.float32)
                    blend = reg * (1.0 - mb) + sub_rgbs[s] * mb
                    rgbs[s][y0:y1, x0:x1] = (blend + 0.5).astype(np.uint8)
                    occs[s][y0:y1, x0:x1] += mf
                    painter[s][y0:y1, x0:x1][m] = layer

                traj_parts.append(alt_trajs)
                birth_parts.append(
                    np.full(alt_trajs.shape[1], layer, np.int32))

            if layer > 0:
                n0 = trajs.shape[1]
                trajs = np.concatenate(traj_parts, axis=1)
                n_tot = trajs.shape[1]
                vis_full = np.ones((S, n_tot), np.float32)
                vis_full[:, :n0] = visibles
                val_full = np.ones((S, n_tot), np.float32)
                val_full[:, :n0] = valids
                birth = np.concatenate(birth_parts)
                visibles = _mark_covered_by_later_layers(
                    painter, trajs, birth, vis_full)
                valids = val_full

        return rgbs, occs, masks, trajs, visibles, valids

    def getitem_helper(self, index: int):
        # index may be VIRTUAL (>= len): the loader passes i + epoch*len so
        # crops/augs/point-subsets re-randomize every epoch (the reference's
        # torch loader draws fresh global randomness per epoch) while staying
        # a pure function of (seed, index) — deterministic across workers.
        rgb_dir, traj_dir, mask_dir, start_ind = self.samples[index % len(self.samples)]
        rng = np.random.RandomState((self.seed + index * 7919) % (1 << 31))

        trajs = np.load(os.path.join(traj_dir, f"trajs_at_{start_ind}.npz"),
                        allow_pickle=True)
        trajs = dict(trajs)["trajs"].astype(np.float32)  # (S_load, N, 2)
        S_load, N, _ = trajs.shape
        assert S_load == self.S_load
        trajs = trajs[:, rng.permutation(N)]
        valids = np.ones((S_load, N), np.float32)
        visibles = np.ones((S_load, N), np.float32)
        if N < self.N:
            return None, False

        img_names = self._frame_names(rgb_dir, start_ind)
        if len(img_names) < self.S_load:  # clip too short for this window
            return None, False
        rgbs, masks = [], []
        for img_name in img_names:
            rgbs.append(_load_webp_cached(os.path.join(rgb_dir, img_name + ".webp")))
            masks.append(_load_mask_cached(os.path.join(mask_dir, img_name + ".pfm")))

        if self.S < self.S_load:
            s0 = rng.randint(0, self.S_load - self.S)
            rgbs, masks = rgbs[s0:s0 + self.S], masks[s0:s0 + self.S]
            trajs = trajs[s0:s0 + self.S]
            visibles = visibles[s0:s0 + self.S]
            valids = valids[s0:s0 + self.S]

        rgbs, occs, masks, trajs, visibles, valids = self._add_occluders(
            rgbs, masks, trajs, visibles, valids, rng)

        if self.use_augs:
            rgbs, trajs, visibles = photometric_augs(rgbs, trajs, visibles, rng)
            rgbs, occs, masks, trajs = spatial_augs(rgbs, occs, masks, trajs,
                                                    visibles, rng, self.crop_size)
        else:
            rgbs, occs, masks, trajs = just_crop(rgbs, occs, masks, trajs, rng,
                                                 self.crop_size)

        trajs, visibles, valids = visibility_filter(
            trajs, visibles, valids, occs, self.crop_size,
            force_twice_vis=self.force_twice_vis,
            force_last_vis=self.force_last_vis,
            force_all_inb=self.force_all_inb)

        if trajs.shape[1] <= self.N:
            return None, False

        inds = rng.choice(trajs.shape[1], self.N, replace=False)
        trajs_full = np.zeros((self.S, self.N, 2), np.float32)
        visibles_full = np.zeros((self.S, self.N), np.float32)
        valids_full = np.zeros((self.S, self.N), np.float32)
        trajs_full[:] = trajs[:, inds]
        visibles_full[:] = visibles[:, inds]
        valids_full[:] = valids[:, inds]

        sample = {
            # stack with a target dtype: one copy, not stack-then-astype
            "rgbs": np.stack(rgbs).astype(np.float32, copy=False),
            "occs": np.stack(occs).astype(np.float32, copy=False),
            "masks": np.stack(masks).astype(np.float32, copy=False),
            "trajs": trajs_full,
            "visibles": visibles_full,
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
                "occs": np.zeros((self.S, H, W), np.float32),
                "masks": np.zeros((self.S, H, W), np.float32),
                "trajs": np.zeros((self.S, self.N, 2), np.float32),
                "visibles": np.zeros((self.S, self.N), np.float32),
                "valids": np.zeros((self.S, self.N), np.float32),
            }
        return sample, gotit
