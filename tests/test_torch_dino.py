"""The port's DINO baseline (``pips_tpu_torch/models/dino.py``), its ViT
converter and its weight loader against the JAX package's, on the CPU, from
seeded weights in the DINO release's layout (``tests/test_vit_convert.py``'s
``make_dino_sd``, its ``pos_embed`` on a 4x4 grid).

Tolerances: the tiny ViT's tokens within 1e-4; ``label_propagation`` within
1e-5 (ties at the k-th value kept); the mask exactly, the soft argmax within
1e-5 px and the heat normalization within 1e-6; the cubic pos-embed resize against
``jax.image.resize`` within 1e-5 where the grid grows and where it shrinks
(antialiased); the heat maps' half-pixel bilinear enlargement within 1e-6;
``DinoTracker`` trajectories within 1e-3 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_vit_convert import make_dino_sd

from pips_tpu.models import dino as jax_dino
from pips_tpu.torchport.convert import convert_dino_vit_state_dict as jax_convert_vit
from pips_tpu_torch.convert import load_flax_params
from pips_tpu_torch.evals import common
from pips_tpu_torch.models import dino
from pips_tpu_torch.ops.resize import resize_half_pixel
from pips_tpu_torch.torchport import convert_dino_vit_state_dict

ARCH = dict(dim=32, heads=4, depth=2)  # patch 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sd():
    return make_dino_sd(np.random.RandomState(0), patch=8, grid=4, **ARCH)


def _port_vit(grid_hw):
    variables = convert_dino_vit_state_dict(_sd(), grid_hw=grid_hw, **ARCH)
    return load_flax_params(dino.ViT(8, grid_hw=grid_hw, dim=32, depth=2, heads=4), variables)


def test_vit_tokens_match_jax():
    grid_hw = (6, 8)
    x = np.random.RandomState(1).randn(2, 48, 64, 3).astype(np.float32)
    variables = jax_convert_vit(_sd(), grid_hw=grid_hw, **ARCH)
    want = np.asarray(jax_dino.ViT(8, 32, 2, 4).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_vit(grid_hw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_attention_chunks_compute_the_same_function(monkeypatch):
    """Chunks of heads and of queries (``CHUNK_ELEMS`` made tiny) give the
    one-shot attention."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 13, 4, 8).astype(np.float32)) for _ in range(3))
    whole = dino.attention(q, k, v)
    monkeypatch.setattr(dino, "CHUNK_ELEMS", 40)  # 3 queries a chunk, one head at a time
    np.testing.assert_allclose(dino.attention(q, k, v).numpy(), whole.numpy(), rtol=0, atol=1e-6)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(-1)
    np.testing.assert_allclose(whole.numpy(), torch.einsum("bhqk,bkhd->bqhd", s, v).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("grid_hw", [(6, 8), (48, 64), (3, 2), (4, 7)])
def test_pos_embed_cubic_resize_matches_jax(grid_hw):
    """Grown (6x8, 48x64: DINO's 28x28 becomes a frame's grid), shrunk
    (3x2: JAX antialiases), and one axis kept (4x7)."""
    got = convert_dino_vit_state_dict(_sd(), grid_hw=grid_hw, **ARCH)["params"]["pos_embed"]
    want = np.asarray(jax_convert_vit(_sd(), grid_hw=grid_hw, **ARCH)["params"]["pos_embed"])
    assert got.shape == want.shape == (1, 1 + grid_hw[0] * grid_hw[1], 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    grid = np.random.RandomState(3).randn(5, 28, 28).astype(np.float32)
    big = jax.image.resize(jnp.asarray(grid), (5, *grid_hw), method="cubic")
    np.testing.assert_allclose(resize_half_pixel(torch.from_numpy(grid), grid_hw, "cubic").numpy(),
                               np.asarray(big), rtol=0, atol=1e-5)


def test_converter_keeps_every_other_leaf_exactly():
    got = convert_dino_vit_state_dict(_sd(), grid_hw=(6, 8), **ARCH)["params"]
    want = jax_convert_vit(_sd(), grid_hw=(6, 8), **ARCH)["params"]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    for (k, a), (_, b) in zip(flat_g, flat_w):
        if "pos_embed" not in str(k):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))


def test_heat_map_enlargement_matches_jax():
    """DinoTracker's half-pixel bilinear upsample of the patch heat maps."""
    heat = np.random.RandomState(4).rand(3, 6, 8).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(heat), (3, 48, 64), method="linear"))
    got = resize_half_pixel(torch.from_numpy(heat), (48, 64), "linear").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 3, 12])
def test_neighborhood_mask_matches_jax(radius):
    got = dino.neighborhood_mask(5, 7, radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dino.neighborhood_mask(5, 7, radius)))


def _propagation_inputs(ties: bool):
    rng = np.random.RandomState(5)
    h, w, n, C, N = 6, 8, 3, 16, 4
    ft = rng.randn(h * w, C).astype(np.float32)
    fs = rng.randn(n, C, h * w).astype(np.float32)
    if ties:  # sources repeated across frames: every affinity comes in triples
        fs[1:] = fs[0]
    segs = rng.rand(n, N, h, w).astype(np.float32)
    return ft, fs, segs, h, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("radius", [2, 12])
def test_label_propagation_matches_jax(ties, radius, monkeypatch):
    """The port's radius against JAX's whole mask: in one chunk, and in a
    grid row a chunk, each computing only the band of source rows in reach
    (radius 2 leaves rows out of it)."""
    ft, fs, segs, h, w = _propagation_inputs(ties)
    mask = jax_dino.neighborhood_mask(h, w, radius)
    want = np.asarray(jax_dino.label_propagation(jnp.asarray(ft), jnp.asarray(fs),
                                                 jnp.asarray(segs), mask, h, w))
    args = (torch.from_numpy(ft), torch.from_numpy(fs), torch.from_numpy(segs), radius, h, w)
    np.testing.assert_allclose(dino.label_propagation(*args).numpy(), want, rtol=0, atol=1e-5)
    monkeypatch.setattr(dino, "CHUNK_ELEMS", 5 * 3 * h * w)
    assert dino._row_step(3, h, w, radius) == 1
    np.testing.assert_allclose(dino.label_propagation(*args).numpy(), want, rtol=0, atol=1e-5)


def test_soft_argmax_and_norm_heat_match_jax():
    rng = np.random.RandomState(6)
    heat = rng.rand(4, 9, 11).astype(np.float32)
    heat[1] = 0.0  # an empty map: norm_heat leaves it, the soft argmax gives 0
    heat[2] -= 2.0  # max <= 0: left as it is
    for fn, tol in (("soft_argmax_xy", 1e-5), ("norm_heat", 1e-6)):
        want = np.asarray(getattr(jax_dino, fn)(jnp.asarray(heat)))
        got = getattr(dino, fn)(torch.from_numpy(heat)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=fn)


@pytest.mark.parametrize("S", [5, 10])
def test_dino_tracker_matches_jax(S):
    """S=10 fills the queue of the last 7 frames and drops from it."""
    rng = np.random.RandomState(7)
    rgbs = (rng.rand(S, 48, 64, 3) * 255).astype(np.float32)
    xy0 = (rng.rand(6, 2) * [63, 47]).astype(np.float32)
    jv = jax_convert_vit(_sd(), grid_hw=(6, 8), **ARCH)
    want = jax_dino.DinoTracker(jax_dino.DinoTracker.make_vit_feat_fn(jv, 8, **ARCH),
                                patch_size=8).track(rgbs, xy0)
    pv = convert_dino_vit_state_dict(_sd(), grid_hw=(6, 8), **ARCH)
    got = dino.DinoTracker(dino.DinoTracker.make_vit_feat_fn(pv, 8, device="cpu", **ARCH),
                           patch_size=8, device="cpu").track(rgbs, xy0)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (S, 6, 2)
    assert np.abs(want - want[:1]).max() > 1.0  # the points moved
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_load_dino_state_dict_reads_a_local_file_and_never_fetches(tmp_path, monkeypatch):
    """A missing file raises ``FileNotFoundError`` naming ``--init_dir`` and
    the release file, and nothing reaches the hub; a present one comes back
    as numpy, also under ``"state_dict"``."""
    fetched = []
    monkeypatch.setattr(torch.hub, "load", lambda *a, **k: fetched.append(a))
    for missing in ("", str(tmp_path / "nope.pth")):
        with pytest.raises(FileNotFoundError, match="dino_deitsmall8_pretrain.pth") as e:
            common.load_dino_state_dict(missing)
        assert "--init_dir" in str(e.value)
    assert fetched == []
    sd = {k: torch.from_numpy(v) for k, v in _sd().items()}
    for i, payload in enumerate((sd, {"state_dict": sd})):
        path = tmp_path / f"dino{i}.pth"
        torch.save(payload, path)
        got = common.load_dino_state_dict(str(path))
        assert sorted(got) == sorted(_sd())
        for k, v in _sd().items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert common.infer_dino_arch(got) == (32, 2, 1, 8)
