"""The port's host library (``pips_tpu_torch/native``) against the JAX
package's (``pips_tpu/native``) and against its own numpy forms, on the same
numpy inputs made from a seed: every C entry of ``tests/test_native.py``,
then the entries that replace the augmentations' cv2 calls, held against cv2.

The port builds its library from its own source into ``build/`` and raises
when it cannot; it never loads the JAX package's prebuilt ``native/`` binary.
Equalities are exact unless a tolerance is stated.
"""

import numpy as np
import pytest

from pips_tpu.native import lib as jax_native
from pips_tpu_torch import native
from pips_tpu_torch.native import lib

cv2 = pytest.importorskip("cv2")


def _write_pfm_bytes(data: np.ndarray, little_endian=True) -> bytes:
    h, w = data.shape[:2]
    color = data.ndim == 3
    header = (b"PF\n" if color else b"Pf\n") + f"{w} {h}\n".encode()
    header += (b"-1.0\n" if little_endian else b"1.0\n")
    payload = np.flipud(data).astype("<f4" if little_endian else ">f4").tobytes()
    return header + payload


def test_library_builds_from_the_port_source_and_loads():
    assert native.ensure_built() and native.available()
    path = lib.library_path()
    assert path.is_file() and path.parent == lib.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "pips_tpu_torch")
    assert lib.SOURCE.parent == path.parents[2] / "pips_tpu_torch" / "native"
    assert lib._load().pips_native_version() == 4


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises with each compiler's words; nothing falls
    back to numpy. A ``$CXX`` that cannot build it (here one that fails) is
    followed by ``g++``."""
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    assert lib._compilers() == ["false", "g++"]
    source = lib.SOURCE
    monkeypatch.setattr(lib, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building the host library failed") as e:
        native.decode_pfm(_write_pfm_bytes(np.zeros((2, 3), np.float32)))
    assert "false -O3" in str(e.value) and "g++ -O3" in str(e.value)
    assert not list((tmp_path / "b").glob("*.so"))
    monkeypatch.setattr(lib, "SOURCE", source)
    assert native.ensure_built() and list((tmp_path / "b").glob("*.so"))


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("shape", [(7, 9), (5, 4, 3)])
def test_decode_pfm_equals_jax_and_reader(tmp_path, rng, shape, little_endian):
    img = rng.randn(*shape).astype(np.float32)
    data = _write_pfm_bytes(img, little_endian)
    got = native.decode_pfm(data)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jax_native.decode_pfm(data))
    np.testing.assert_array_equal(got, lib.decode_pfm_reference(data))
    p = tmp_path / "x.pfm"
    p.write_bytes(data)
    np.testing.assert_array_equal(native.decode_pfm_file(str(p)), got)


def test_composite_equals_jax_and_numpy(rng):
    rgb = rng.rand(2, 8, 10, 3).astype(np.float32)
    alt = rng.rand(2, 8, 10, 3).astype(np.float32)
    mask = rng.rand(2, 8, 10).astype(np.float32)
    mask[0, :2] = 0.0  # untouched pixels
    got = native.composite(rgb.copy(), alt, mask)
    np.testing.assert_array_equal(got, jax_native.composite(rgb.copy(), alt, mask))
    np.testing.assert_array_equal(got, lib.composite_reference(rgb.copy(), alt, mask))


def test_resize_equals_jax_numpy_and_cv2(rng):
    src = rng.rand(12, 16, 3).astype(np.float32)
    for hw in [(7, 9), (30, 41), (12, 16)]:
        got = native.resize_bilinear(src, hw)
        np.testing.assert_array_equal(got, jax_native.resize_bilinear(src, hw))
        np.testing.assert_array_equal(got, lib.resize_bilinear_reference(src, hw))
        want = cv2.resize(src, hw[::-1], interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_chain_step_equals_jax_and_numpy(rng):
    """Exact against the JAX package's C entry everywhere, and against the
    numpy form off half-integer coords: the C entry rounds halves away from
    zero (``roundf``), numpy to even, in both packages."""
    H, W, N = 10, 12, 50
    flow = rng.randn(H, W, 2).astype(np.float32)
    coords = (rng.rand(N, 2) * [W + 4, H + 4] - 2).astype(np.float32)
    half = np.array([[0.5, 0.5], [1.5, 2.5], [-0.5, 3], [W - 0.5, 1], [2, H - 0.5]], np.float32)
    got = native.chain_step(flow, coords.copy())
    np.testing.assert_array_equal(got, jax_native.chain_step(flow, coords.copy()))
    np.testing.assert_array_equal(got, lib.chain_step_reference(flow, coords.copy()))
    got = native.chain_step(flow, half.copy())
    np.testing.assert_array_equal(got, jax_native.chain_step(flow, half.copy()))
    xi = np.clip(np.floor(half[:, 0] + 0.5).astype(int), 0, W - 1)  # halves up (all >= -0.5
    yi = np.clip(np.floor(half[:, 1] + 0.5).astype(int), 0, H - 1)  # clip to 0 either way)
    np.testing.assert_array_equal(got, half + flow[yi, xi])


def test_mark_covered_frame_equals_jax_and_replay(rng):
    """The deferred coverage of ``test_native.py``: a point is hidden by every
    LATER-pasted layer whose support holds its rounded, in-bounds pixel;
    half-integer coords round half to even. A uint16 painter (256 layers or
    more) takes the numpy form, as in the JAX package."""
    H, W, N = 20, 24, 400
    trajs = (rng.rand(N, 2) * [W + 8, H + 8] - 4).astype(np.float32)
    trajs[:32, 0] = np.arange(32) - 4 + 0.5
    trajs[:32, 1] = np.arange(32) % (H + 2)
    birth = rng.randint(0, 4, N).astype(np.int32)
    painter = np.zeros((H, W), np.uint8)
    for k in range(1, 4):
        painter[rng.rand(H, W) < 0.15] = k
    outs = []
    for fn, p in [(native.mark_covered_frame, painter),
                  (jax_native.mark_covered_frame, painter),
                  (lib.mark_covered_frame_reference, painter),
                  (native.mark_covered_frame, painter.astype(np.uint16))]:
        vis = np.ones(N, np.float32)
        fn(p, trajs, birth, vis)
        outs.append(vis)
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    assert 0 < (outs[0] == 0).sum() < N


def test_visibility_frame_equals_jax_and_numpy(rng):
    H, W, N = 16, 20, 300
    trajs = (rng.rand(N, 2) * [W + 6, H + 6] - 3).astype(np.float32)
    trajs[:6] = [[0, 0], [W - 1, H - 1], [W - 0.5, 2], [-0.5, 3], [W - 1.5, H - 0.5],
                 [0.49, -0.49]]
    occ = np.zeros((H, W), np.float32)
    occ[:, :4] = 255.0
    occ[5:9, 10:15] = 255.0
    vis0 = (rng.rand(N) > 0.2).astype(np.float32)
    outs = []
    for fn in (native.visibility_frame, jax_native.visibility_frame,
               lib.visibility_frame_reference):
        vis, inb = vis0.copy(), np.empty(N, np.uint8)
        fn(trajs, occ, vis, inb)
        outs.append((vis, inb))
    for vis, inb in outs[1:]:
        np.testing.assert_array_equal(outs[0][0], vis)
        np.testing.assert_array_equal(outs[0][1], inb)


def test_mark_in_rects_equals_jax_and_float_compares(rng):
    H, W, N = 30, 40, 500
    xy = (rng.rand(N, 2) * [W + 10, H + 10] - 5).astype(np.float32)
    rects = []
    for _ in range(8):
        x0, y0 = rng.randint(0, W - 2), rng.randint(0, H - 2)
        rects.append((x0, x0 + rng.randint(1, W - x0), y0, y0 + rng.randint(1, H - y0)))
    x0, x1, y0, y1 = rects[0]
    xy[:4] = [(x0 - 1e-3, y0 + 0.5), (x0, y0), (x1 - 1e-3, y1 - 1e-3), (x1, y0)]
    rects = np.asarray(rects, np.int32)
    got, jx, ref = (np.ones(N, np.float32) for _ in range(3))
    assert native.mark_in_rects(xy, rects, got)
    assert jax_native.mark_in_rects(xy, rects, jx)
    lib.mark_in_rects_reference(xy, rects, ref)
    np.testing.assert_array_equal(got, jx)
    np.testing.assert_array_equal(got, ref)


def _jitter_matrix(rng, img):
    """The colour jitter's affine (``augs.color_jitter``) at random strengths."""
    b, c, s = rng.uniform(0.8, 1.2, 3)
    m = float(img.mean())
    M = np.full((3, 4), b * c * (1 - s) / 3)
    M[:, 3] = b * m * (1 - c)
    M[np.arange(3), np.arange(3)] += b * c * s
    return M


def test_color_affine_equals_cv2_transform(rng):
    """Exact against ``cv2.transform`` (its 8-bit fixed point) on images of
    every brightness range, offsets of both signs."""
    for _ in range(30):
        lo = rng.randint(0, 200)
        img = rng.randint(lo, rng.randint(lo + 1, 257), (24, 40, 3)).astype(np.uint8)
        M = _jitter_matrix(rng, img)
        want = cv2.transform(img, M)
        np.testing.assert_array_equal(native.color_affine(img, M), want)
        np.testing.assert_array_equal(lib.color_affine_reference(img, M), want)


def _all_colours() -> np.ndarray:
    c = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(4096, 4096, 3)


def test_hue_shift_equals_cv2_on_every_colour():
    """Exact against cv2's uint8 RGB -> HSV -> RGB round trip with the hue
    shifted, over all 2^24 colours for the C entry (the numpy form over a
    seeded 2^18 of them), at shifts of both signs and zero."""
    img = _all_colours()
    rows = np.random.RandomState(0).randint(0, 4096, 64)
    for shift in (-44, 0, 13):
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 180
        want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        np.testing.assert_array_equal(native.hue_shift(img, shift), want)
        np.testing.assert_array_equal(lib.hue_shift_reference(img[rows], shift), want[rows])


def test_gaussian_blur_equals_cv2(rng):
    """Exact against ``cv2.GaussianBlur(img, (11, 11), sigma)`` on uint8 at
    the augs' sigmas (0.1-2), images from 1 px (all border) to 48 px, one
    and three channels."""
    from pips_tpu_torch.data.augs import gaussian_taps

    for t in range(40):
        H, W = rng.randint(1, 48), rng.randint(1, 48)
        img = rng.randint(0, 256, (H, W, 3) if t % 2 else (H, W)).astype(np.uint8)
        sigma = rng.uniform(0.1, 2.0)
        taps = gaussian_taps(11, sigma)
        assert taps.sum() == 256 and (taps == taps[::-1]).all()
        want = cv2.GaussianBlur(img, (11, 11), sigma)
        np.testing.assert_array_equal(native.gaussian_blur(img, taps), want)
        np.testing.assert_array_equal(lib.gaussian_blur_reference(img, taps), want)


def test_entries_refuse_what_they_cannot_take():
    with pytest.raises(ValueError):
        native.gaussian_blur(np.zeros((4, 4), np.float32), np.array([256], np.int32))
    with pytest.raises(ValueError):
        native.color_affine(np.zeros((4, 4), np.uint8), np.eye(3, 4))
    with pytest.raises(ValueError):
        native.decode_pfm(b"P6\n2 2\n255\n" + bytes(12))
