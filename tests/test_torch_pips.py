"""The port's Pips, parameter bridge and WindowTracker against the JAX package.

Tolerances (docs/TESTING.md, "Numerical-chaos policy"): the refinement
iterates corr lookups through floor(), and with untrained weights each
iteration amplifies a difference by ~100x. So one iteration is compared
tightly and two within a bounded drift:

* f32, iters=1: trajectories 2e-3 px, visibility logits 1e-3 (measured
  3.4e-4 px and 3.3e-5);
* f32, iters=2: max 0.5 px, median 0.05 px of drift (measured 0.045 and
  0.0034), on trajectories that move tens of pixels;
* bf16 + fused channel blocks, iters=1: the coordinate deltas are bf16, one
  ulp of which is 0.0625 px here; max 1 px, median 0.2 px, visibility 0.25
  (measured 0.31 px, 0.047 px, 0.075).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.models import Pips as JaxPips
from pips_tpu_torch import Pips, WindowTracker
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params, state_dict_from_flax

TINY = dict(S=8, stride=8, latent_dim=16, mixer_dim=32, mixer_depth=2)


def _inputs():
    rng = np.random.RandomState(0)
    rgbs = (rng.rand(1, 8, 64, 96, 3) * 255).astype(np.float32)
    xys = (rng.rand(1, 12, 2) * [80, 48] + 8).astype(np.float32)
    return xys, rgbs


@functools.lru_cache(maxsize=None)
def _jax_model(bf16: bool):
    kw = dict(dtype=jnp.bfloat16, fuse_chanff=True) if bf16 else {}
    m = JaxPips(**TINY, **kw)
    xys, rgbs = _inputs()
    params = jax.jit(lambda k: m.init(k, jnp.asarray(xys), jnp.asarray(rgbs), iters=1))(
        jax.random.PRNGKey(0))
    # non-zero biases and non-unit norm scales, so a mis-mapped leaf shows
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                          params)
    return m, params  # cached: callers copy before they change it


def _both(bf16: bool, iters: int, corr_mode: str):
    m, params = _jax_model(bf16)
    xys, rgbs = _inputs()
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(lambda p, x, r: m.apply(p, x, r, iters=iters, corr_mode=corr_mode))(
            params, jnp.asarray(xys), jnp.asarray(rgbs))
    want = (np.asarray(out.coord_predictions[-1]), np.asarray(out.vis_e, np.float32))
    tm = Pips(**TINY, **(dict(dtype=torch.bfloat16, fuse_chanff=True) if bf16 else {}))
    load_flax_params(tm, params).eval()
    with torch.no_grad():
        o = tm(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=iters, corr_mode=corr_mode)
    got = (o.coord_predictions[-1].numpy(), o.vis_e.float().numpy())
    return got, want, xys


def test_bridge_round_trip_is_identity():
    _, params = _jax_model(bf16=False)
    tm = Pips(**TINY)
    load_flax_params(tm, params)
    back = flax_from_state_dict(tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(k))
    # the conv layout really changes, dense kernels keep theirs
    sd = state_dict_from_flax(params)
    assert sd["fnet.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["delta_block.to_delta.block0_chan.fc1.kernel"].shape == (32, 128)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_bridge_rejects_missing_and_extra_leaves(change):
    params = jax.tree.map(np.copy, _jax_model(bf16=False)[1])
    if change == "missing":
        del params["params"]["vis_predictor"]["bias"]
    else:
        params["params"]["vis_predictor"]["scale"] = np.ones(1, np.float32)
    with pytest.raises(KeyError):
        load_flax_params(Pips(**TINY), params)


@pytest.mark.parametrize("corr_mode", ["onehot", "full"])
def test_pips_one_iteration_tight(corr_mode):
    (trajs, vis), (jtrajs, jvis), xys = _both(False, 1, corr_mode)
    np.testing.assert_allclose(trajs, jtrajs, rtol=0, atol=2e-3)
    np.testing.assert_allclose(vis, jvis, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(trajs[:, 0], xys)  # eval locks frame 0


def test_pips_two_iterations_bounded_drift():
    (trajs, vis), (jtrajs, jvis), _ = _both(False, 2, "onehot")
    d = np.abs(trajs - jtrajs)
    assert d.max() < 0.5 and np.median(d) < 0.05, (d.max(), np.median(d))
    assert np.abs(np.asarray(jtrajs) - trajs[:, :1]).max() > 5.0  # the points did move


def test_pips_bf16_fused_matches_jax_interpret():
    (trajs, vis), (jtrajs, jvis), xys = _both(True, 1, "onehot")
    d = np.abs(trajs - jtrajs)
    assert d.max() < 1.0 and np.median(d) < 0.2, (d.max(), np.median(d))
    assert np.abs(vis - jvis).max() < 0.25
    np.testing.assert_array_equal(trajs[:, 0], xys)


def test_window_tracker_equals_model_call():
    tm = Pips(**TINY)
    load_flax_params(tm, _jax_model(bf16=False)[1]).eval()
    xys, rgbs = _inputs()
    tracker = WindowTracker(tm, iters=2, corr_mode="onehot", device="cpu")
    trajs, vis = tracker(xys, rgbs)
    with torch.no_grad():
        o = tm(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=2, corr_mode="onehot")
    np.testing.assert_array_equal(trajs, o.coord_predictions[-1].numpy())
    np.testing.assert_array_equal(vis, o.vis_e.numpy())
    coords, vis2, _ = tracker.track(tracker.encode(rgbs), xys)
    np.testing.assert_array_equal(coords.numpy(), trajs)
    np.testing.assert_array_equal(vis2.numpy(), vis)


def test_track_with_coords_and_feat_init_matches_jax():
    """The chaining entry: track from given coords and frame-0 features."""
    m, params = _jax_model(bf16=False)
    xys, rgbs = _inputs()
    rng = np.random.RandomState(7)
    coords0 = (np.broadcast_to(xys[:, None], (1, 8, 12, 2))
               + rng.randn(1, 8, 12, 2) * 3).astype(np.float32)
    feat0 = rng.randn(1, 12, 16).astype(np.float32)

    def jax_track(p, r, x, c, f):
        fm = m.apply(p, r, method="encode")
        return m.apply(p, fm, x, coords_init=c, feat_init=f, iters=1, corr_mode="onehot",
                       method="track")

    out = jax.jit(jax_track)(params, jnp.asarray(rgbs), jnp.asarray(xys), jnp.asarray(coords0),
                             jnp.asarray(feat0))
    tm = load_flax_params(Pips(**TINY), params).eval()
    with torch.no_grad():
        o = tm.track(tm.encode(torch.from_numpy(rgbs)), torch.from_numpy(xys),
                     coords_init=torch.from_numpy(coords0), feat_init=torch.from_numpy(feat0),
                     iters=1, corr_mode="onehot")
    np.testing.assert_array_equal(o.ffeat.numpy(), feat0)
    np.testing.assert_allclose(o.coord_predictions[-1].numpy(),
                               np.asarray(out.coord_predictions[-1]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(o.vis_e.numpy(), np.asarray(out.vis_e), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(o.coord_predictions[-1][:, 0].numpy(), coords0[:, 0])


def test_query_helpers_match_jax():
    from pips_tpu.inference.window import dense_queries as jax_dense
    from pips_tpu.inference.window import grid_queries as jax_grid
    from pips_tpu_torch import dense_queries, grid_queries

    np.testing.assert_array_equal(grid_queries(384, 512), jax_grid(384, 512))
    np.testing.assert_array_equal(grid_queries(64, 96, 3, 5, 4), jax_grid(64, 96, 3, 5, 4))
    np.testing.assert_array_equal(dense_queries(64, 96), jax_dense(64, 96))
