"""The port's ops (pips_tpu_torch.ops, kernels.corr_onehot) against the JAX ops.

Same numpy inputs through both. f32 comparisons are tight (1e-5: only the
summation order differs); bf16 ones allow one bf16 rounding step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.kernels.corr_pallas import sample_corr_onehot as jax_sample_corr_onehot
from pips_tpu.ops import corr as jcorr
from pips_tpu.ops import embed as jembed
from pips_tpu.ops import grids as jgrids
from pips_tpu.ops import resize as jresize
from pips_tpu.ops import samp as jsamp
from pips_tpu_torch.kernels.corr_onehot import sample_corr_onehot
from pips_tpu_torch.ops import corr, embed, grids, resize, samp

TIGHT = dict(rtol=1e-5, atol=1e-5)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def test_grids():
    np.testing.assert_array_equal(grids.gridcloud2d(2, 3, 5).numpy(),
                                  np.asarray(jgrids.gridcloud2d(2, 3, 5)))
    for a, b in zip(grids.meshgrid2d(1, 4, 6), jgrids.meshgrid2d(1, 4, 6)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _img_and_oob_coords(rng):
    img = rng.randn(2, 7, 9, 3)
    # in-bounds, straddling the border, and far outside on every side
    x = np.concatenate([rng.uniform(0, 8, (2, 12)), rng.uniform(-3, 12, (2, 12)),
                        np.array([[-1.5, 9.7, 8.0, -0.2]] * 2)], axis=1)
    y = np.concatenate([rng.uniform(0, 6, (2, 12)), rng.uniform(-3, 10, (2, 12)),
                        np.array([[3.0, -0.4, 6.9, 7.5]] * 2)], axis=1)
    return img, x, y



def test_meshgrid2d_stacked_and_coords_grid():
    """``stack`` in JAX's position (the 4th argument), and ``coords_grid``, xy order."""
    np.testing.assert_array_equal(grids.meshgrid2d(2, 3, 5, True).numpy(),
                                  np.asarray(jgrids.meshgrid2d(2, 3, 5, True)))
    got = grids.meshgrid2d(1, 4, 6, stack=True, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 6, 2)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jgrids.meshgrid2d(1, 4, 6, stack=True)))
    np.testing.assert_array_equal(grids.coords_grid(2, 3, 4).numpy(),
                                  np.asarray(jgrids.coords_grid(2, 3, 4)))
    assert grids.coords_grid(1, 2, 3, dtype=torch.float64).dtype == torch.float64


def test_bilinear_sample2d_inbounds_flag():
    """As ``tests/test_ops.py``: a 4x4 image at x = [-0.6, 0, 3.4, 3.6], y = 1."""
    x, y = np.array([[-0.6, 0.0, 3.4, 3.6]]), np.ones((1, 4))
    img = np.zeros((1, 4, 4, 1))
    out, inb = samp.bilinear_sample2d(t(img), t(x), t(y), return_inbounds=True)
    want_out, want_inb = jsamp.bilinear_sample2d(j(img), j(x), j(y), return_inbounds=True)
    assert inb.dtype == torch.float32
    np.testing.assert_array_equal(inb[0].numpy(), [0, 1, 1, 0])
    np.testing.assert_array_equal(inb.numpy(), np.asarray(want_inb))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))


def test_bilinear_sample2d_inbounds_matches_jax(rng):
    img, x, y = _img_and_oob_coords(rng)
    out, inb = samp.bilinear_sample2d(t(img), t(x), t(y), return_inbounds=True)
    want_out, want_inb = jsamp.bilinear_sample2d(j(img), j(x), j(y), return_inbounds=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TIGHT)
    np.testing.assert_array_equal(inb.numpy(), np.asarray(want_inb))
    assert 0 < inb.sum() < inb.numel()


@pytest.mark.parametrize("name", ["grid_sample_zeros", "bilinear_sample2d"])
def test_samplers_out_of_bounds(rng, name):
    img, x, y = _img_and_oob_coords(rng)
    got = getattr(samp, name)(t(img), t(x), t(y)).numpy()
    want = np.asarray(getattr(jsamp, name)(j(img), j(x), j(y)))
    np.testing.assert_allclose(got, want, **TIGHT)


def test_sampler_semantics_differ_outside(rng):
    """Zero padding fades to 0 off the map; border replication does not."""
    img = np.ones((1, 4, 4, 1))
    x, y = np.array([[-5.0, 10.0]]), np.array([[1.0, 1.0]])
    assert np.all(samp.grid_sample_zeros(t(img), t(x), t(y)).numpy() == 0.0)
    assert np.all(samp.bilinear_sample2d(t(img), t(x), t(y)).numpy() == 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_hw", [(5, 7), (16, 24), (1, 3)])
def test_resize_align_corners(rng, dtype, out_hw):
    img = rng.randn(2, 11, 13, 4)  # channel-last for JAX; the port resizes the last two axes
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = resize.resize_bilinear_align_corners(t(img, tdt).permute(0, 3, 1, 2), out_hw)
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(jresize.resize_bilinear_align_corners(j(img, jdt), out_hw), np.float32)
    tol = TIGHT if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


def test_avg_pool_and_pyramid(rng):
    fm = rng.randn(1, 2, 9, 13, 5)  # odd sizes: floor like the reference
    np.testing.assert_allclose(resize.avg_pool2x2(t(fm)).numpy(),
                               np.asarray(jresize.avg_pool2x2(j(fm))), **TIGHT)
    for a, b in zip(corr.build_fmap_pyramid(t(fm), 3), jcorr.build_fmap_pyramid(j(fm), 3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)


def test_3d_embedding(rng):
    xyz = rng.randn(2, 5, 3) * 4
    np.testing.assert_allclose(embed.get_3d_embedding(t(xyz), 64).numpy(),
                               np.asarray(jembed.get_3d_embedding(j(xyz), 64)),
                               rtol=1e-5, atol=2e-5)


def _corr_case(rng, B=1, S=2, N=6, H=12, W=10, C=8, levels=3):
    fm = rng.randn(B, S, H, W, C)
    targets = rng.randn(B, S, N, C)
    coords = np.stack([rng.uniform(-4, W + 3, (B, S, N)),
                       rng.uniform(-4, H + 3, (B, S, N))], -1)
    return fm, targets, coords, levels


def test_corr_pyramid_and_full_sampling(rng):
    fm, targets, coords, L = _corr_case(rng)
    tp = corr.build_fmap_pyramid(t(fm), L)
    jp = jcorr.build_fmap_pyramid(j(fm), L)
    tc, jc = corr.corr_pyramid(tp, t(targets)), jcorr.corr_pyramid(jp, j(targets))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    got = corr.sample_corr_pyramid(tc, t(coords), radius=3).numpy()
    want = np.asarray(jcorr.sample_corr_pyramid(jc, j(coords), radius=3))
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_corr_onehot_matches_jax(rng, dtype):
    fm, targets, coords, L = _corr_case(rng)
    jc = jcorr.corr_pyramid(jcorr.build_fmap_pyramid(j(fm), L), j(targets))
    jc = [c.astype(getattr(jnp, dtype)) for c in jc]
    tc = [torch.from_numpy(np.array(c, np.float32)).to(getattr(torch, dtype)) for c in jc]
    got = sample_corr_onehot(tc, t(coords), radius=3)
    want = np.asarray(jax_sample_corr_onehot(jc, j(coords), radius=3))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # the score maps are equal bits; only the f32 bilinear combine may round differently
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)


def test_sample_corr_onehot_equals_full_sampling(rng):
    fm, targets, coords, L = _corr_case(rng)
    tc = corr.corr_pyramid(corr.build_fmap_pyramid(t(fm), L), t(targets))
    np.testing.assert_allclose(sample_corr_onehot(tc, t(coords)).numpy(),
                               corr.sample_corr_pyramid(tc, t(coords)).numpy(), **TIGHT)


@pytest.mark.parametrize("sampler", ["onehot", "full"])
def test_transposed_patch_order(sampler):
    """patch[i, j] is sampled at (x + o_i, y + o_j): on a map equal to its x
    coordinate, the patch varies along i only."""
    H, W, r = 20, 20, 3
    P = 2 * r + 1
    ramp = torch.arange(W, dtype=torch.float32).expand(H, W).reshape(1, 1, 1, H, W)
    coords = torch.tensor([[[[9.0, 11.0]]]])
    fn = sample_corr_onehot if sampler == "onehot" else corr.sample_corr_pyramid
    patch = fn([ramp], coords, radius=r).reshape(P, P).numpy()
    offs = np.arange(-r, r + 1, dtype=np.float32)
    np.testing.assert_array_equal(patch, np.broadcast_to((9.0 + offs)[:, None], (P, P)))


@pytest.mark.parametrize("keepdims", [False, True])
def test_reduce_masked_mean_takes_jax_keywords(keepdims):
    """``reduce_masked_mean`` takes JAX's ``axis``/``keepdims``, and the ops
    package exports it and ``normalize`` as JAX's does."""
    from pips_tpu.ops import reduce_masked_mean as jax_reduce_masked_mean
    from pips_tpu.ops import normalize as jax_normalize
    from pips_tpu_torch.ops import normalize, reduce_masked_mean

    want = np.asarray(jax_reduce_masked_mean(jnp.ones((2, 3)), jnp.ones((2, 3)), axis=1,
                                             keepdims=keepdims))
    got = reduce_masked_mean(torch.ones(2, 3), torch.ones(2, 3), axis=1, keepdims=keepdims)
    assert got.shape == want.shape == ((2, 1) if keepdims else (2,))
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    both = reduce_masked_mean(torch.ones(2, 3), torch.ones(2, 3), keepdims=keepdims)
    jboth = np.asarray(jax_reduce_masked_mean(jnp.ones((2, 3)), jnp.ones((2, 3)),
                                              keepdims=keepdims))
    assert both.shape == jboth.shape
    np.testing.assert_allclose(both.numpy(), jboth, **TIGHT)
    d = np.random.RandomState(0).randn(2, 5)
    np.testing.assert_allclose(normalize(t(d)).numpy(), np.asarray(jax_normalize(j(d))), **TIGHT)
