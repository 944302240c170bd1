"""The port's augmentations (``pips_tpu_torch/data/augs.py``) against the JAX
package's (``pips_tpu/data/augs.py``, which calls cv2) on the same numpy
inputs and the same random draws, and the invariants of
``tests/test_augs.py``.

The port has no cv2 call: the colour jitter, hue shift and blur go through
its host library and equal cv2 exactly here (the hue shift on whole SIMD
chunks of cv2's rows; see ``test_color_jitter_equals_jax``). The resize is the host
library's half-pixel bilinear in f32, where cv2 has its own f32 rounding:
stated tolerances below. uint8 resizes (cv2 in fixed point) stay within
one level.
"""

import numpy as np
import pytest

from pips_tpu.data import augs as jax_augs
from pips_tpu_torch.data import augs

cv2 = pytest.importorskip("cv2")

# spatial_augs' f32 frames after the drifting resize, against cv2's resize
# of the same frames: measured at most 0.0035 levels over the seeds below
# (rgbs, occ and masks); allowed 0.05
RESIZE_LEVELS = 0.05


def _frames(S, H, W, seed=0):
    return [(np.random.RandomState(seed + s).rand(H, W, 3) * 255).astype(np.uint8)
            for s in range(S)]


def _unfused_jitter(rgb, rng, brightness=0.2, contrast=0.2, saturation=0.2):
    img = rgb.astype(np.float32)
    img = img * rng.uniform(1 - brightness, 1 + brightness)
    mean = img.mean()
    img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    gray = img.mean(axis=2, keepdims=True)
    img = (img - gray) * rng.uniform(1 - saturation, 1 + saturation) + gray
    return np.clip(img, 0, 255).astype(np.uint8)


def test_color_jitter_matches_unfused_chain():
    img = (np.random.RandomState(3).rand(64, 96, 3) * 255).astype(np.uint8)
    for seed in range(5):
        got = augs.color_jitter(img, np.random.RandomState(seed), hue=0.0)
        want = _unfused_jitter(img, np.random.RandomState(seed))
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        assert got.dtype == np.uint8


@pytest.mark.parametrize("hue", [0.0, 0.25 / 3.14])
def test_color_jitter_equals_jax(hue):
    """Exact on rows of 64 px (whole SIMD chunks of cv2's HSV -> RGB, where it
    truncates); on a row's last W mod 32-64 px cv2 takes a scalar path that
    rounds, so a hue-shifted pixel there may sit one level off (80 px rows:
    measured 6.6% of values one level off, none more)."""
    for W in (64, 80):
        img = (np.random.RandomState(4).rand(48, W, 3) * 255).astype(np.uint8)
        img[:4] = 0
        img[4:8] = 255
        for seed in range(8):
            a, b = np.random.RandomState(seed), np.random.RandomState(seed)
            got = augs.color_jitter(img, a, hue=hue)
            want = jax_augs.color_jitter(img, b, hue=hue)
            if W == 64 or hue == 0.0:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got.astype(np.int32) - want).max() <= 1
            assert a.rand() == b.rand()  # the same number of draws


def test_color_jitter_deterministic_and_identity_at_zero_strength():
    img = (np.random.RandomState(0).rand(32, 48, 3) * 255).astype(np.uint8)
    a = augs.color_jitter(img, np.random.RandomState(7))
    b = augs.color_jitter(img, np.random.RandomState(7))
    np.testing.assert_array_equal(a, b)
    ident = augs.color_jitter(img, np.random.RandomState(7), brightness=0.0,
                              contrast=0.0, saturation=0.0, hue=0.0)
    np.testing.assert_array_equal(ident, img)


def test_gaussian_blur_equals_jax():
    for seed, shape in enumerate([(40, 56, 3), (5, 7, 3), (1, 9, 3), (30, 2, 3)]):
        img = (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(augs.gaussian_blur(img, a), jax_augs.gaussian_blur(img, b))


def test_resize_forms_against_cv2():
    """INTER_LINEAR: f32 within 2e-3 levels of cv2 (measured 1.1e-3),
    uint8 within one level; INTER_NEAREST exact."""
    rng = np.random.RandomState(5)
    for _ in range(30):
        H, W = rng.randint(2, 50), rng.randint(2, 50)
        hw = (rng.randint(1, 100), rng.randint(1, 100))
        f = (rng.rand(H, W, 3) * 255).astype(np.float32)
        want = cv2.resize(f, hw[::-1], interpolation=cv2.INTER_LINEAR)
        assert np.abs(augs.resize_linear(f, hw) - want).max() <= 2e-3
        got2d = augs.resize_linear(f[..., 0], hw)
        assert got2d.shape == hw and np.abs(got2d - want[..., 0]).max() <= 2e-3
        u = f.astype(np.uint8)
        got = augs.resize_linear(u, hw)
        assert got.dtype == np.uint8
        want = cv2.resize(u, hw[::-1], interpolation=cv2.INTER_LINEAR)
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        seg = rng.randint(0, 3, (H, W)).astype(np.uint8)
        np.testing.assert_array_equal(augs.resize_nearest(seg, hw),
                                      cv2.resize(seg, hw[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("name", ["replace_aug", "eraser_aug"])
def test_occlusion_augs_equal_jax_and_keep_invariants(name):
    """``tests/test_augs.py``'s invariants (frame 0 untouched, inputs not
    mutated, some frame changed, visibility only lowered, trajs unchanged),
    and the same frames and visibility as the JAX package's aug."""
    S, H, W, N = 4, 64, 128, 20  # rows of whole 64 px chunks: see the jitter test
    rgbs = _frames(S, H, W)
    orig = [r.copy() for r in rgbs]
    trajs = (np.random.RandomState(1).rand(S, N, 2) * [W, H]).astype(np.float32)
    vis = np.ones((S, N), np.float32)
    out, trajs_o, vis_o = getattr(augs, name)(rgbs, trajs, vis.copy(), np.random.RandomState(11),
                                              prob=1.0)
    want, _, vis_w = getattr(jax_augs, name)([r.copy() for r in orig], trajs, vis.copy(),
                                             np.random.RandomState(11), prob=1.0)
    assert all(o.dtype == np.uint8 and o.shape == (H, W, 3) for o in out)
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)
    np.testing.assert_array_equal(vis_o, vis_w)
    np.testing.assert_array_equal(out[0], orig[0])
    for s in range(S):
        np.testing.assert_array_equal(rgbs[s], orig[s])
    assert any(not np.array_equal(out[s], orig[s]) for s in range(1, S))
    assert (vis_o <= vis).all()
    np.testing.assert_array_equal(trajs_o, trajs)


def test_eraser_aug_marks_covered_points_invisible():
    S, H, W = 3, 48, 64
    rgbs = _frames(S, H, W)
    trajs = np.tile(np.array([[10.0, 10.0]], np.float32), (S, 8, 1))
    trajs += np.random.RandomState(2).rand(S, 8, 2) * 30
    vis = np.ones((S, 8), np.float32)
    out, _, vis_o = augs.eraser_aug([r.copy() for r in rgbs], trajs, vis, np.random.RandomState(5),
                                    prob=1.0)
    assert (vis_o <= vis).all()
    changed = [not np.array_equal(o, r) for o, r in zip(out, rgbs)]
    assert not changed[0] and any(changed[1:])


def test_mark_in_rects_equals_jax_and_float_compares():
    rng = np.random.RandomState(9)
    H, W, N = 30, 40, 500
    xy = (rng.rand(N, 2) * [W + 10, H + 10] - 5).astype(np.float32)
    rects = []
    for _ in range(8):
        x0, y0 = rng.randint(0, W - 2), rng.randint(0, H - 2)
        rects.append((x0, x0 + rng.randint(1, W - x0), y0, y0 + rng.randint(1, H - y0)))
    x0, x1, y0, y1 = rects[0]
    xy[:8] = [(x0 - 1e-3, y0 + 0.5), (x0, y0), (x1 - 1e-3, y1 - 1e-3), (x1, y0),
              (x0 + 0.5, y1), (-0.5, y0), (x0 + 0.1, y1 - 0.1), (x1 - 0.5, y0 + 0.5)]
    r = np.asarray(rects, np.float32)
    x, y = xy[:, 0], xy[:, 1]
    want = np.ones(N, np.float32)
    want[((x >= r[:, 0, None]) & (x < r[:, 1, None])
          & (y >= r[:, 2, None]) & (y < r[:, 3, None])).any(axis=0)] = 0
    for args in [(xy, (H, W)), (xy, None), (xy.astype(np.float64), (H, W))]:
        got = np.ones(N, args[0].dtype)
        jx = np.ones(N, args[0].dtype)
        augs._mark_in_rects(args[0], rects, got, args[1])
        jax_augs._mark_in_rects(args[0], rects, jx, args[1])
        np.testing.assert_array_equal(got.astype(np.float32), want)
        np.testing.assert_array_equal(got, jx)


@pytest.mark.parametrize("seed", range(4))
def test_photometric_augs_equal_jax(seed):
    S, H, W, N = 4, 48, 64, 30
    rgbs = _frames(S, H, W, seed)
    trajs = (np.random.RandomState(seed).rand(S, N, 2) * [W, H]).astype(np.float32)
    vis = np.ones((S, N), np.float32)
    a = augs.photometric_augs(rgbs, trajs, vis.copy(), np.random.RandomState(seed),
                              color_prob=1.0, blur_prob=1.0)
    b = jax_augs.photometric_augs(rgbs, trajs, vis.copy(), np.random.RandomState(seed),
                                  color_prob=1.0, blur_prob=1.0)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("seed", range(4))
def test_spatial_augs_against_jax(seed):
    """Trajectories exact (the same draws, scales and crops); frames, occ
    and masks within ``RESIZE_LEVELS`` of the JAX package's cv2 resize."""
    S, H, W, N = 4, 60, 80, 50
    rgbs = _frames(S, H, W, seed)
    rng = np.random.RandomState(seed)
    occs = [np.where(rng.rand(H, W) < 0.1, 255.0, 0.0).astype(np.float32) for _ in range(S)]
    masks = [(rng.rand(H, W) < 0.3).astype(np.float32) for _ in range(S)]
    trajs = (rng.rand(S, N, 2) * [W, H]).astype(np.float32)
    vis = (rng.rand(S, N) > 0.3).astype(np.float32)
    crop = (40, 56)
    a = augs.spatial_augs(rgbs, occs, masks, trajs, vis, np.random.RandomState(seed), crop)
    b = jax_augs.spatial_augs(rgbs, occs, masks, trajs, vis, np.random.RandomState(seed), crop)
    np.testing.assert_array_equal(a[3], b[3])
    for xs, ys in zip(a[:3], b[:3]):
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and x.shape[:2] == crop and x.dtype == np.float32
            assert np.abs(x - y).max() <= RESIZE_LEVELS


def test_just_crop_equals_jax():
    S, H, W = 3, 50, 70
    rgbs = _frames(S, H, W)
    occs = [np.zeros((H, W), np.float32)] * S
    trajs = (np.random.RandomState(0).rand(S, 9, 2) * [W, H]).astype(np.float32)
    a = augs.just_crop(rgbs, occs, occs, trajs, np.random.RandomState(2), (32, 40))
    b = jax_augs.just_crop(rgbs, occs, occs, trajs, np.random.RandomState(2), (32, 40))
    for xs, ys in zip(a[:3], b[:3]):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[3], b[3])
