"""The port's losses, masked reductions and train-time score maps against the
JAX package, on the same seeded numpy inputs.

Everything here is f32 elementwise work and sums, so the bounds are a few f32
ulps of the values' magnitude: 1e-5 relative (1e-6 absolute) for the losses
and reductions, and 1e-4 absolute for score maps of magnitude ~10, whose two
forms (one product against the fused map, or a resize of each level's
product) sum in other orders. The in-loop CE equals the stacked CE to 1e-5
relative, the JAX test's bound for the same identity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.models import losses as jlosses
from pips_tpu.ops import corr as jcorr
from pips_tpu.ops import reduce as jreduce
from pips_tpu_torch import make_pips
from pips_tpu_torch.models import losses
from pips_tpu_torch.ops import corr, reduce

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _gt(rng, B=2, S=4, N=6, H8=8, W8=12):
    """Feature-map trajectories with in-bounds, out-of-bounds and exact
    half-pixel positions (where round-half-to-even decides the cell)."""
    trajs = rng.uniform(-2, [W8 + 1, H8 + 1], (B, S, N, 2))
    trajs[:, :, 0] = np.floor(trajs[:, :, 0]) + 0.5  # ties
    vis = (rng.rand(B, S, N) > 0.3).astype(np.float32)
    valids = (rng.rand(B, S, N) > 0.1).astype(np.float32)
    return trajs.astype(np.float32), vis, valids


def test_reduce_and_normalize_match_jax():
    rng = np.random.RandomState(0)
    x, mask = rng.randn(3, 4, 5), (rng.rand(3, 4, 5) > 0.5).astype(np.float32)
    for axis in (None, 1, (0, 2)):
        want = np.asarray(jreduce.reduce_masked_mean(jnp.asarray(x, jnp.float32),
                                                     jnp.asarray(mask), axis=axis))
        got = reduce.reduce_masked_mean(_t(x), _t(mask), axis=axis).numpy()
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    # an empty mask divides by EPS alone, as in JAX
    assert reduce.reduce_masked_mean(_t(x), torch.zeros(3, 4, 5)).item() == 0.0
    d = rng.randn(2, 3, 7) * 4
    np.testing.assert_allclose(reduce.normalize(_t(d)).numpy(),
                               np.asarray(jreduce.normalize(jnp.asarray(d, jnp.float32))),
                               **LOSS_TOL)
    np.testing.assert_allclose(reduce.normalize_single(_t(d)).numpy(),
                               np.asarray(jreduce.normalize_single(jnp.asarray(d, jnp.float32))),
                               **LOSS_TOL)


def test_balanced_ce_and_sequence_loss_match_jax():
    rng = np.random.RandomState(1)
    pred, gt = rng.randn(2, 4, 6) * 3, (rng.rand(2, 4, 6) > 0.5).astype(np.float32)
    valid = (rng.rand(2, 4, 6) > 0.2).astype(np.float32)
    want, want_el = jlosses.balanced_ce_loss(jnp.asarray(pred, jnp.float32), jnp.asarray(gt),
                                             jnp.asarray(valid))
    got, got_el = losses.balanced_ce_loss(_t(pred), _t(gt), _t(valid))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(got_el.numpy(), np.asarray(want_el), **LOSS_TOL)
    got_nv, _ = losses.balanced_ce_loss(_t(pred), _t(gt))
    want_nv, _ = jlosses.balanced_ce_loss(jnp.asarray(pred, jnp.float32), jnp.asarray(gt))
    np.testing.assert_allclose(got_nv.item(), float(want_nv), **LOSS_TOL)

    preds, flow_gt = rng.randn(5, 2, 4, 6, 2) * 10, rng.randn(2, 4, 6, 2) * 10
    want = jlosses.sequence_loss(jnp.asarray(preds, jnp.float32), jnp.asarray(flow_gt,
                                                                             jnp.float32),
                                 jnp.asarray(gt), jnp.asarray(valid), 0.8)
    got = losses.sequence_loss(_t(preds), _t(flow_gt), _t(gt), _t(valid), 0.8)
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def test_score_map_losses_match_jax():
    rng = np.random.RandomState(2)
    trajs, vis, valids = _gt(rng)
    fcps = rng.randn(2, 4, 3, 6, 8, 12).astype(np.float32) * 4
    j = [jnp.asarray(a) for a in (fcps, trajs, vis, valids)]
    t = [_t(a) for a in (fcps, trajs, vis, valids)]
    np.testing.assert_allclose(losses.score_map_loss(*t).item(),
                               float(jlosses.score_map_loss(*j)), **LOSS_TOL)
    for i in range(3):
        want = float(jlosses.score_map_loss_single_iter(j[0][:, :, i], *j[1:]))
        got = losses.score_map_loss_single_iter(t[0][:, :, i], *t[1:]).item()
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    # the separable single-iteration form averages to the stacked loss
    mean_single = np.mean([losses.score_map_loss_single_iter(t[0][:, :, i], *t[1:]).item()
                           for i in range(3)])
    np.testing.assert_allclose(mean_single, losses.score_map_loss(*t).item(), rtol=1e-5)
    # bf16 logits are widened first, as in JAX
    jb = float(jlosses.score_map_loss_single_iter(j[0][:, :, 0].astype(jnp.bfloat16), *j[1:]))
    tb = losses.score_map_loss_single_iter(t[0][:, :, 0].bfloat16(), *t[1:]).item()
    np.testing.assert_allclose(tb, jb, **LOSS_TOL)


def test_fused_pyramid_score_maps_match_jax_and_per_level_form():
    rng = np.random.RandomState(3)
    fmaps = rng.randn(1, 2, 12, 20, 16).astype(np.float32)
    targets = rng.randn(1, 2, 5, 16).astype(np.float32)
    pyr_t = corr.build_fmap_pyramid(_t(fmaps), 3)
    pyr_j = jcorr.build_fmap_pyramid(jnp.asarray(fmaps), 3)
    fm_t = corr.fused_pyramid_fmap(pyr_t, (12, 20))
    np.testing.assert_allclose(fm_t.numpy(), np.asarray(jcorr.fused_pyramid_fmap(pyr_j, (12, 20))),
                               rtol=0, atol=1e-5)
    fused = corr.fcp_from_fused(fm_t, _t(targets))
    per_level = corr.fcp_score_maps(corr.corr_pyramid(pyr_t, _t(targets)), (12, 20))
    want = np.asarray(jcorr.fcp_score_maps(jcorr.corr_pyramid(pyr_j, jnp.asarray(targets)),
                                           (12, 20)))
    assert fused.shape == per_level.shape == (1, 2, 5, 12, 20) and fused.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), per_level.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(per_level.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(fused.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("iters", [1, 2])
def test_inloop_ce_matches_stacked(iters):
    """``ce_gt`` sums the CE inside the loop; it equals ``score_map_loss`` of
    the stacked ``fcps`` of the same forward."""
    from pips_tpu_torch.data import SyntheticPointDataset

    model = make_pips(device="cpu", seed=4, **TINY)
    sample, _ = SyntheticPointDataset(S=4, N=8, H=64, W=96, seed=3)[0]
    b = {k: _t(v[None]) for k, v in sample.items()}
    with torch.no_grad():
        stacked = model(b["trajs"][:, 0], b["rgbs"], iters=iters, is_train=True,
                        compute_fcp=True)
        lean = model(b["trajs"][:, 0], b["rgbs"], iters=iters, is_train=True, compute_fcp=True,
                     ce_gt=(b["trajs"], b["visibles"], b["valids"]))
    assert stacked.fcps.shape == (1, 4, iters, 8, 8, 12) and stacked.ce_loss is None
    assert lean.fcps is None
    want = losses.score_map_loss(stacked.fcps, b["trajs"] / 8.0, b["visibles"], b["valids"])
    np.testing.assert_allclose(lean.ce_loss.item(), want.item(), rtol=1e-5)
    np.testing.assert_array_equal(lean.coord_predictions.numpy(),
                                  stacked.coord_predictions.numpy())
