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


@pytest.mark.parametrize("corr_mode", ["onehot", "full", "fused", "pallas"])
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


@pytest.mark.parametrize("corr_mode", ["fused", "pallas"])
def test_pips_bf16_fused_corr_modes_match_jax_interpret(corr_mode):
    """The f32-score corr modes in bf16 with fused channel blocks, held to the
    bounds of the onehot case above; JAX runs its Pallas kernels (corr and
    channel block) in interpret mode, the port their plain versions."""
    (trajs, vis), (jtrajs, jvis), xys = _both(True, 1, corr_mode)
    d = np.abs(trajs - jtrajs)
    assert d.max() < 1.0 and np.median(d) < 0.2, (d.max(), np.median(d))
    assert np.abs(vis - jvis).max() < 0.25
    np.testing.assert_array_equal(trajs[:, 0], xys)


def test_pallas_mode_equals_fused_mode_on_cpu():
    """On CPU tensors the kernel mode runs the plain version, bit for bit."""
    tm = load_flax_params(Pips(**TINY), _jax_model(bf16=False)[1]).eval()
    xys, rgbs = _inputs()
    with torch.no_grad():
        a, b = (tm(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=2, corr_mode=m)
                for m in ("pallas", "fused"))
    np.testing.assert_array_equal(a.coord_predictions.numpy(), b.coord_predictions.numpy())
    np.testing.assert_array_equal(a.vis_e.numpy(), b.vis_e.numpy())


def test_window_tracker_corr_mode_arguments():
    tm = Pips(**TINY)
    assert WindowTracker(tm, corr_mode="pallas", device="cpu").corr_mode == "pallas"
    assert WindowTracker(tm, use_fused_corr=True, device="cpu").corr_mode == "fused"
    assert WindowTracker(tm, use_fused_corr=False, device="cpu").corr_mode == "full"
    with pytest.raises(ValueError, match="corr_mode"):
        WindowTracker(tm, corr_mode="gather", device="cpu")


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


def test_window_tracker_track_takes_numpy_like_jax():
    """``WindowTracker.track`` takes numpy fmaps (kept in their dtype) and a
    numpy (1, N, C) feat_init (taken as f32), as the JAX tracker does, and
    agrees with it at the one-iteration bounds above."""
    from pips_tpu.inference.window import WindowTracker as JaxWindowTracker

    m, params = _jax_model(bf16=False)
    xys, rgbs = _inputs()
    feat0 = np.random.RandomState(8).randn(1, 12, 16)  # float64: the tracker takes it as f32
    jt = JaxWindowTracker(m, params, iters=1, corr_mode="onehot")
    fmaps = np.asarray(jt.encode(rgbs), np.float32)
    want = [np.asarray(a) for a in jt.track(fmaps, xys, feat0)]
    tracker = WindowTracker(load_flax_params(Pips(**TINY), params), iters=1,
                            corr_mode="onehot", device="cpu")
    coords, vis, ffeat = tracker.track(fmaps, xys, feat0)
    assert ffeat.dtype == torch.float32
    np.testing.assert_array_equal(ffeat.numpy(), feat0.astype(np.float32))
    np.testing.assert_allclose(coords.numpy(), want[0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(vis.numpy(), want[1], rtol=0, atol=1e-3)
    # without feat_init, numpy fmaps alone
    coords2, _, ffeat2 = tracker.track(fmaps, xys)
    want2 = [np.asarray(a) for a in jt.track(fmaps, xys)]
    np.testing.assert_allclose(coords2.numpy(), want2[0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(ffeat2.numpy(), want2[2], rtol=0, atol=1e-4)
    # numpy's bf16 (ml_dtypes, as JAX hands out bf16 arrays) stays bf16
    import ml_dtypes

    tb = WindowTracker(load_flax_params(Pips(**TINY, dtype=torch.bfloat16), params), iters=1,
                       corr_mode="onehot", device="cpu")
    fm16 = torch.from_numpy(fmaps.copy()).bfloat16()
    a = tb.track(fm16.float().numpy().astype(ml_dtypes.bfloat16), xys, feat0)
    b = tb.track(fm16, torch.from_numpy(xys), torch.from_numpy(feat0).float())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.float().numpy(), y.float().numpy())


# the argument-order case: widths of their own, so that a swapped width shows
TINY_ORDER = dict(S=8, stride=8, latent_dim=32, mixer_dim=64, mixer_depth=2)
# the calls both packages take in JAX's argument order: positionally
# (coords_init, feat_init, iters, is_train, compute_fcp), and by keyword with
# use_fused_corr and no corr_mode
ORDER_CALLS = {"positional compute_fcp": ((None, None, 1, False, True), {}),
               "use_fused_corr": ((), dict(iters=1, use_fused_corr=True))}


@functools.lru_cache(maxsize=None)
def _jax_order_outputs():
    m = JaxPips(**TINY_ORDER)
    xys, rgbs = _inputs()
    params = jax.jit(lambda k: m.init(k, jnp.asarray(xys), jnp.asarray(rgbs), iters=1))(
        jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                          params)
    outs = {}
    for name, (args, kw) in ORDER_CALLS.items():
        out = jax.jit(lambda p, x, r: m.apply(p, x, r, *args, **kw))(
            params, jnp.asarray(xys), jnp.asarray(rgbs))
        outs[name] = jax.tree.map(lambda a: None if a is None else np.asarray(a, np.float32), out)
    return params, outs


@pytest.mark.parametrize("call", sorted(ORDER_CALLS))
def test_pips_takes_jax_argument_order(call):
    """``Pips.forward`` and ``track`` take JAX's order (..., iters, is_train,
    compute_fcp, use_fused_corr, corr_mode, ce_gt), and a corr_mode left None
    resolves from use_fused_corr as JAX resolves it; held to the one-iteration
    bounds above, the score maps (fcps) to the visibility logits' 1e-3."""
    params, outs = _jax_order_outputs()
    want = outs[call]
    args, kw = ORDER_CALLS[call]
    xys, rgbs = _inputs()
    tm = load_flax_params(Pips(**TINY_ORDER), params).eval()
    with torch.no_grad():
        o = tm(torch.from_numpy(xys), torch.from_numpy(rgbs), *args, **kw)
    np.testing.assert_allclose(o.coord_predictions.numpy(), want.coord_predictions,
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(o.vis_e.numpy(), want.vis_e, rtol=0, atol=1e-3)
    assert (o.fcps is None) == (want.fcps is None)
    if want.fcps is not None:
        assert o.fcps.shape == want.fcps.shape == (1, 8, 1, 12, 8, 12)
        np.testing.assert_allclose(o.fcps.numpy(), want.fcps, rtol=0, atol=1e-3)


# JAX's Pips fields after the widths, in order: dtype, then six flags
JAX_FLAGS = ("remat_mixer", "remat_corr", "remat_encoder", "fuse_chanff", "fuse_conv3",
             "full_s2d")


def _port_flags(m: Pips) -> dict:
    """The port's flags as its modules hold them."""
    return {"remat_mixer": m.delta_block.remat, "remat_corr": m.remat_corr,
            "remat_encoder": m.fnet.remat, "fuse_chanff": m.delta_block.to_delta.fuse_chanff,
            "fuse_conv3": m.fnet.fuse_conv3, "full_s2d": m.fnet.full_s2d}


@pytest.mark.parametrize("flip", JAX_FLAGS)
def test_pips_fields_take_jax_positional_order(flip):
    """``Pips.__init__`` takes JAX's field order: the same positional tuple, up
    to the 14th field, gives both classes the same widths and flags. Each
    case turns one flag from its default, so a swapped pair shows."""
    widths = (8, 8, 16, 3, 2, 32, 2, None)
    flags = tuple((not d) if name == flip else d
                  for name, d in zip(JAX_FLAGS, (False, False, False, False, False, True)))
    jm = JaxPips(*widths, *flags)
    tm = Pips(*widths, *flags)
    assert [f for f in JaxPips.__dataclass_fields__ if f not in ("parent", "name")][:14] == [
        "S", "stride", "latent_dim", "corr_levels", "corr_radius", "mixer_dim", "mixer_depth",
        "dtype", *JAX_FLAGS]
    assert _port_flags(tm) == {name: getattr(jm, name) for name in JAX_FLAGS}
    assert (tm.S, tm.stride, tm.latent_dim, tm.corr_levels, tm.corr_radius) == (
        jm.S, jm.stride, jm.latent_dim, jm.corr_levels, jm.corr_radius)
    assert tm.fnet.dtype is None and jm.dtype is None
