"""The port's readers (``pips_tpu_torch/data``: FlyingThings++, PointOdyssey,
BADJA, CroHD, the frame decoder) and ``ops/fps.py`` against the JAX
package's, on the trees of ``tests/tests_treeutil.py`` and the same seeds.

Without augs a sample equals the JAX package's exactly: rgbs, occs, masks,
trajs, visibles and valids. With augs the trajectories and valids are
exact (the same draws); the frames differ only where the JAX package's cv2
rounds otherwise (the resize in f32, the hue shift on a row's scalar tail),
within the tolerances stated below.
"""

import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests_treeutil import make_badja_tree, make_crohd_tree, make_flyingthings_tree

from pips_tpu.data import badja as jax_badja
from pips_tpu.data import crohd as jax_crohd
from pips_tpu.data import flyingthings as jax_ft
from pips_tpu.data import pointodyssey as jax_po
from pips_tpu.ops import fps as jax_fps
from pips_tpu_torch.data import badja, crohd, flyingthings, pfm, pointodyssey
from pips_tpu_torch.ops import fps

# with augs, |port - JAX| over the samples below: rgbs measured at most
# 0.0053 levels (FlyingThings++) and 0.0017 (PointOdyssey), occs and masks
# at most 0.0052; visibles flipped on no point. Allowed: one level more on
# rgbs, where a hue-shifted frame's row is no whole number of cv2's SIMD
# chunks (see tests/test_torch_augs.py)
RGB_LEVELS = 1.05
MAP_LEVELS = 0.05
VIS_FLIP_SHARE = 0.01


@pytest.fixture(scope="module")
def ft_root(tmp_path_factory):
    return make_flyingthings_tree(tmp_path_factory.mktemp("flt"))


def _pair(root, **kw):
    return (flyingthings.FlyingThingsDataset(root, **kw),
            jax_ft.FlyingThingsDataset(root, **kw))


def _assert_close_sample(a, b, augs: bool):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if not augs or k in ("trajs", "valids"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if augs:
        assert np.abs(a["rgbs"] - b["rgbs"]).max() <= RGB_LEVELS
        for k in ("occs", "masks"):
            if k in a:
                assert np.abs(a[k] - b[k]).max() <= MAP_LEVELS, k
        assert (a["visibles"] != b["visibles"]).mean() <= VIS_FLIP_SHARE


def test_index_scan_equals_jax(ft_root):
    a, b = _pair(ft_root, dset="TRAIN", subset="all", N=16, S=8, crop_size=(96, 128))
    assert len(a) == 6 and len(a.occluders) == 6
    assert a.samples == b.samples and a.occluders == b.occluders


def test_getitem_no_augs_equals_jax(ft_root):
    a, b = _pair(ft_root, dset="TRAIN", subset="A", N=16, S=8, crop_size=(96, 128),
                 use_augs=False)
    for idx in range(6):
        (sa, ga), (sb, gb) = a[idx], b[idx]
        assert ga and gb
        _assert_close_sample(sa, sb, augs=False)
    assert sa["rgbs"].shape == (8, 96, 128, 3) and sa["trajs"].shape == (8, 16, 2)
    assert sa["valids"][0].sum() == 16
    assert (sa["trajs"][0, :, 0] >= 0).all() and (sa["trajs"][0, :, 0] <= 127).all()


def test_getitem_with_augs_against_jax(ft_root):
    a, b = _pair(ft_root, dset="TRAIN", subset="A", N=8, S=8, crop_size=(96, 128),
                 use_augs=True)
    got = 0
    for idx in range(6):
        (sa, ga), (sb, gb) = a[idx], b[idx]
        assert ga == gb
        got += ga
        _assert_close_sample(sa, sb, augs=True)
        assert np.isfinite(sa["trajs"]).all()
    assert got


def test_shorter_S_and_fake_sample_equal_jax(ft_root):
    a, b = _pair(ft_root, dset="TRAIN", subset="A", N=8, S_load=8, S=4, crop_size=(96, 128))
    (sa, ga), (sb, gb) = a[0], b[0]
    assert ga and gb and sa["rgbs"].shape == (4, 96, 128, 3)
    _assert_close_sample(sa, sb, augs=False)
    a, b = _pair(ft_root, dset="TRAIN", subset="A", N=5000, S=8, crop_size=(96, 128))
    (sa, ga), (sb, gb) = a[0], b[0]
    assert not ga and not gb and sa["valids"].sum() == 0
    _assert_close_sample(sa, sb, augs=False)


@pytest.mark.parametrize("flags", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, True, True),
                                   (False, False, False)])
def test_visibility_filter_equals_jax(flags):
    rng = np.random.RandomState(9)
    S, N, H, W = 5, 400, 40, 56
    trajs = (rng.rand(S, N, 2) * [W + 20, H + 20] - 10).astype(np.float32)
    trajs[0, :4] = [[W - 1, H - 1], [-0.5, 5], [W - 0.6, 5], [0, 0]]
    occs = [np.where(rng.rand(H, W) < 0.3, 255.0, 0.0).astype(np.float32) for _ in range(S)]
    visibles = (rng.rand(S, N) > 0.2).astype(np.float32)
    valids = np.ones((S, N), np.float32)
    kw = dict(force_twice_vis=flags[0], force_last_vis=flags[1], force_all_inb=flags[2])
    got = flyingthings.visibility_filter(trajs, visibles, valids, occs, (H, W), **kw)
    want = jax_ft.visibility_filter(trajs, visibles, valids, occs, (H, W), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mask_blur_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    for shape in [(1, 1), (1, 7), (6, 1), (2, 2), (44, 64), (13, 30)]:
        m = (rng.rand(*shape) < 0.5).astype(np.float32)
        np.testing.assert_array_equal(flyingthings._blur_mask3(m), cv2.GaussianBlur(m, (3, 3), 0))


def _make_po_tree(root, T=12, H=128, W=192, N=200, seed=0):
    """The PointOdyssey tree of ``tests/test_data_other.py`` (frames, points
    and their visibility from a seed), larger, with a val split."""
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        seq = root / split / "seq0"
        (seq / "rgbs").mkdir(parents=True)
        for fr in range(T):
            Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
                seq / "rgbs" / f"rgb_{fr + 1:05d}.jpg")
        trajs = rng.rand(T, N, 2) * [W - 4, H - 4] + 2
        vis = (rng.rand(T, N) > 0.1).astype(np.float64)
        np.savez(seq / "annotations.npz", trajs_2d=trajs, visibilities=vis)
    return str(root)


@pytest.fixture(scope="module")
def po_root(tmp_path_factory):
    return _make_po_tree(tmp_path_factory.mktemp("po"))


@pytest.mark.parametrize("use_augs", [False, True])
@pytest.mark.parametrize("N", [16, 150])
def test_pointodyssey_equals_jax(po_root, use_augs, N):
    """Of 200 points per clip, N=16 takes a farthest-point subsample of the
    survivors of the crop and visibility filters, N=150 pads them with zeros
    where fewer survive; both the same draws as the JAX package. With augs
    the trajectories, visibles and valids stay exact."""
    kw = dict(dset="train", S=8, N=N, crop_size=(64, 96), use_augs=use_augs)
    a = pointodyssey.PointOdysseyDataset(po_root, **kw)
    b = jax_po.PointOdysseyDataset(po_root, **kw)
    assert a.clips == b.clips and len(a) == 4
    got = []
    for idx in range(len(a)):
        (sa, ga), (sb, gb) = a[idx], b[idx]
        assert ga == gb
        np.testing.assert_array_equal(sa["visibles"], sb["visibles"])
        _assert_close_sample(sa, sb, augs=use_augs)
        assert sa["rgbs"].shape == (8, 64, 96, 3) and sa["trajs"].shape == (8, N, 2)
        if ga:
            got.append(sa["valids"][0].sum())
    assert got
    if not use_augs:  # the crop keeps 20-28 points: N=150 pads
        assert all(n == N for n in got) == (N == 16)
    val = pointodyssey.PointOdysseyDataset(po_root, dset="val", S=8, N=N, crop_size=(64, 96))
    assert len(val) == 4 and val[0][1]


def test_badja_equals_jax(tmp_path):
    """The BADJA reader of ``tests/test_data_other.py`` on the shared tree;
    a segmentation of another size than its frame goes through the port's
    INTER_NEAREST form, as through cv2's in the JAX package."""
    root = make_badja_tree(tmp_path, T=5)
    seg = tmp_path / "DAVIS/Annotations/Full-Resolution/bear/00002.png"
    small = np.zeros((23, 31), np.uint8)
    small[5:15, 8:20] = 255
    Image.fromarray(small).save(seg)
    ann = json.loads((tmp_path / "joint_annotations" / "bear.json").read_text())
    (tmp_path / "joint_annotations" / "bear.json").write_text(json.dumps(ann[:2] + ann[3:]))
    a, b = badja.BadjaDataset(root), jax_badja.BadjaDataset(root)
    assert len(a) == len(b) == 1 and a.video_name(0) == b.video_name(0) == "bear"
    da, db = a[0], b[0]
    assert sorted(da) == sorted(db)
    for k in da:
        if isinstance(da[k], np.ndarray):
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        else:
            assert da[k] == db[k]
    assert da["segs"].shape == da["rgbs"].shape[:3]
    assert (da["trajs"][2] == 0).all() and (da["visibles"][2] == 0).all()
    np.testing.assert_array_equal(badja.JOINT_COLORS, jax_badja.JOINT_COLORS)


def test_crohd_equals_jax(tmp_path):
    root = make_crohd_tree(tmp_path, H=32, W=48)
    a = crohd.CrohdDataset(seqlen=24, dset="t", dataset_root=root)
    b = jax_crohd.CrohdDataset(seqlen=24, dset="t", dataset_root=root)
    assert len(a) == len(b) == 4
    for idx in (0, 3):
        sa, sb = a[idx], b[idx]
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
        for req in (False, True):
            (pa, oka), (pb, okb) = (crohd.prep_sample(sa, N_max=16, req_occlusion=req),
                                    jax_crohd.prep_sample(sb, N_max=16, req_occlusion=req))
            assert oka == okb
            if oka:
                for k in pa:
                    np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert sa["rgbs"].shape == (24, 32, 48, 3)
    with pytest.raises(ValueError):
        crohd.CrohdDataset(dset="x", dataset_root=root)


def test_read_image_equals_jax_decoders_and_names_pil(tmp_path, monkeypatch):
    """One decoder for every reader: PIL, as the JAX package's FlyingThings++
    and PointOdyssey readers decode (its BADJA and CroHD go through
    imageio, which hands jpg and png to PIL too)."""
    rng = np.random.RandomState(0)
    img = (rng.rand(20, 30, 3) * 255).astype(np.uint8)
    for ext in ("webp", "jpg", "png"):
        p = str(tmp_path / f"x.{ext}")
        Image.fromarray(img).save(p, **({"lossless": True} if ext == "webp" else {}))
        got = pfm.read_image(p)
        np.testing.assert_array_equal(got, jax_ft._load_webp(p))
        np.testing.assert_array_equal(got, jax_badja._imread(p))
        if ext != "jpg":
            np.testing.assert_array_equal(got, img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        pfm.read_image(p)


@pytest.mark.parametrize("npoint", [1, 7, 40])
def test_farthest_point_sample_equals_jax(npoint):
    rng = np.random.RandomState(npoint)
    xyz = rng.rand(3, 50, 2).astype(np.float32)
    for kw in [dict(deterministic=True), dict(seed=5), dict(seed=5, include_ends=True)]:
        got = fps.farthest_point_sample(torch.from_numpy(xyz), npoint, **kw)
        want = np.asarray(jax_fps.farthest_point_sample(xyz, npoint, **kw))
        assert got.dtype == torch.int32 and got.shape == (3, npoint)
        np.testing.assert_array_equal(got.numpy(), want)
    for n in (npoint, 60):  # 60 > N: the noisy branch
        a = fps.farthest_point_sample_py(xyz[0], n, np.random.RandomState(1))
        b = jax_fps.farthest_point_sample_py(xyz[0], n, np.random.RandomState(1))
        np.testing.assert_array_equal(a, b)
