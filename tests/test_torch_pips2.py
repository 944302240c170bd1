"""The port's Pips2 (PIPs++), its bridge and its trackers against the JAX package.

TINY dims (latent 16, 3 corr levels of radius 2, refiner 32 x 2), weights from
the JAX init at S=4 (perturbed, so no leaf is trivial) carried over by
convert.py; the JAX fused channel block runs in Pallas interpret mode.
Tolerances follow the "Numerical-chaos policy" of docs/TESTING.md: one
refinement iteration is compared tightly, and so is a chain of windows of
one iteration each.

* f32, iters=1, every corr mode, fused channel blocks on and off, at S=4, 6
  and 10 with the one set of weights: trajectories within 2e-3 px,
  visibility logits within 1e-3 (measured <= 1.6e-4 px and 1.5e-5 on points
  that move ~26 px): the two differ by f32 summation order only;
* bf16 with fused channel blocks, iters=1: the coordinate deltas are bf16
  (one ulp is 0.0625 px here), so max 1 px, median 0.2 px, visibility 0.25,
  the bounds of tests/test_torch_pips.py's bf16 case;
* ChainTracker(S=6), f32, fixed skip, one iteration a window (policy (b)):
  every frame within 2e-3 px, visibility within 1e-3 (measured 4.4e-5 px and
  3.6e-7, windows at 0, 3 and 6). Untrained Pips2 weights amplify a
  difference ~300x an iteration here (JAX's own fused-vs-full gap: 7.6e-6,
  2.0e-3, 1.3 px after one, two, three), so at two iterations a window the
  encoder's f32 summation-order gap (6.9e-5 px after one) reaches 0.5 px in
  the first window: chaos, not the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.inference import ChainTracker as JaxChainTracker
from pips_tpu.models import Pips2 as JaxPips2
from pips_tpu_torch import ChainTracker, Pips, Pips2, WindowTracker, init_params
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params, state_dict_from_flax
from pips_tpu_torch.kernels import mixer_cuda

TINY = dict(stride=8, latent_dim=16, corr_levels=3, corr_radius=2, refiner_dim=32,
            refiner_depth=2)
TRAJ_ATOL, VIS_ATOL = 2e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_chain.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _frames(S: int):
    rng = np.random.RandomState(S)
    rgbs = (rng.rand(1, S, 64, 96, 3) * 255).astype(np.float32)
    xys = (np.random.RandomState(0).rand(1, 12, 2) * [80, 48] + 8).astype(np.float32)
    return xys, rgbs


def _jax_kw(fuse: bool, bf16: bool) -> dict:
    return dict(fuse_chanff=fuse, **(dict(dtype=jnp.bfloat16) if bf16 else {}))


@functools.lru_cache(maxsize=None)
def _params(fuse: bool):
    """JAX init at S=4, every leaf perturbed; the tree is the same for both
    dtypes."""
    m = JaxPips2(**TINY, fuse_chanff=fuse)
    xys, rgbs = _frames(4)
    params = jax.jit(lambda k: m.init(k, jnp.asarray(xys), jnp.asarray(rgbs), iters=1))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    return jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                        params)


@functools.lru_cache(maxsize=None)
def _jax_out(fuse: bool, bf16: bool, corr_mode: str, S: int, iters: int = 1):
    m = JaxPips2(**TINY, **_jax_kw(fuse, bf16))
    xys, rgbs = _frames(S)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(lambda p, x, r: m.apply(p, x, r, iters=iters, corr_mode=corr_mode))(
            _params(fuse), jnp.asarray(xys), jnp.asarray(rgbs))
    return np.asarray(out.coord_predictions[-1]), np.asarray(out.vis_e, np.float32)


def _port(fuse: bool, bf16: bool = False) -> Pips2:
    m = Pips2(**TINY, fuse_chanff=fuse, **(dict(dtype=torch.bfloat16) if bf16 else {}))
    return load_flax_params(m, _params(fuse)).eval()


def _port_out(model, S: int, iters: int = 1, **kw):
    xys, rgbs = _frames(S)
    with torch.no_grad():
        out = model(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=iters, **kw)
    return out, out.coord_predictions[-1].numpy(), out.vis_e.float().numpy()


@pytest.mark.parametrize("fuse", [False, True])
def test_pips2_bridge_round_trip_is_identity(fuse):
    """The JAX tree (fused or not: the same names) goes into the port and back
    leaf for leaf; the depthwise temporal kernel keeps flax's (3, 1, D)."""
    params = _params(fuse)
    tm = Pips2(**TINY, fuse_chanff=fuse)
    load_flax_params(tm, params)
    back = flax_from_state_dict(tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(k))
    sd = state_dict_from_flax(params)
    assert sd["refiner.block0.tconv.kernel"].shape == (3, 1, 32)
    assert sd["refiner.block1.cff.fc1.kernel"].shape == (32, 128)
    assert sorted(sd) == sorted(state_dict_from_flax(_params(not fuse)))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("corr_mode", ["full", "fused", "onehot"])
def test_pips2_one_iteration_matches_jax(corr_mode, fuse):
    out, trajs, vis = _port_out(_port(fuse), 4, corr_mode=corr_mode)
    jtrajs, jvis = _jax_out(fuse, False, corr_mode, 4)
    np.testing.assert_allclose(trajs, jtrajs, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(vis, jvis, rtol=0, atol=VIS_ATOL)
    assert np.abs(jtrajs - _frames(4)[0][:, None]).max() > 5.0  # the points did move
    assert out.fcps is None and out.ce_loss is None
    assert out.coord_predictions2.shape == (1 + 4, 1, 4, 12, 2)


@pytest.mark.parametrize("S", [6, 10])
def test_pips2_weights_are_s_agnostic(S):
    """Weights made at S=4 track windows of 6 and 10 frames, in both packages
    alike, with fused channel blocks and without."""
    for fuse in (False, True):
        _, trajs, vis = _port_out(_port(fuse), S, corr_mode="onehot")
        jtrajs, jvis = _jax_out(fuse, False, "onehot", S)
        assert trajs.shape == (1, S, 12, 2)
        np.testing.assert_allclose(trajs, jtrajs, rtol=0, atol=TRAJ_ATOL)
        np.testing.assert_allclose(vis, jvis, rtol=0, atol=VIS_ATOL)


def test_pips2_bf16_fused_matches_jax_interpret():
    _, trajs, vis = _port_out(_port(True, bf16=True), 4, corr_mode="onehot")
    jtrajs, jvis = _jax_out(True, True, "onehot", 4)
    d = np.abs(trajs - jtrajs)
    assert d.max() < 1.0 and np.median(d) < 0.2, (d.max(), np.median(d))
    assert np.abs(vis - jvis).max() < 0.25
    np.testing.assert_array_equal(trajs[:, 0], _frames(4)[0])


def test_pips2_locks_the_query_frame_in_eval_only():
    model = _port(False)
    xys = _frames(6)[0]
    for iters in (1, 2):
        _, trajs, _ = _port_out(model, 6, iters=iters)
        np.testing.assert_array_equal(trajs[:, 0], xys)
    out, trajs, _ = _port_out(model, 6, is_train=True)
    assert np.abs(trajs[:, 0] - xys).max() > 1e-3
    np.testing.assert_array_equal(out.coord_predictions2[0, :, 0].numpy(), xys)


def test_pips2_pallas_mode_computes_full_as_jax_does():
    """Pips2 has no kernel branch: any mode but ``fused`` and ``onehot``
    computes ``full``, bit for bit, in JAX and in the port."""
    model = _port(False)
    _, full, vfull = _port_out(model, 4, corr_mode="full")
    _, pallas, vpallas = _port_out(model, 4, corr_mode="pallas")
    np.testing.assert_array_equal(pallas, full)
    np.testing.assert_array_equal(vpallas, vfull)
    jfull, _ = _jax_out(False, False, "full", 4)
    jpallas, _ = _jax_out(False, False, "pallas", 4)
    np.testing.assert_array_equal(jpallas, jfull)
    np.testing.assert_allclose(pallas, jpallas, rtol=0, atol=TRAJ_ATOL)


def test_pips2_takes_jax_argument_order():
    """``forward`` and ``track`` take the JAX order; ``use_fused_corr`` picks
    ``fused`` when no corr_mode is given, ``full`` otherwise."""
    model = _port(False)
    xys, rgbs = _frames(4)
    x, r = torch.from_numpy(xys), torch.from_numpy(rgbs)
    with torch.no_grad():
        pos = model(x, r, None, None, 1, False, True, True, None, None)
        kw = model(x, r, iters=1, corr_mode="fused")
        plain = model(x, r, iters=1)
        full = model(x, r, iters=1, corr_mode="full")
        fmaps = model.encode(r)
        tr = model.track(fmaps, x, None, None, 1, False, True, None)
    assert torch.equal(pos.coord_predictions, kw.coord_predictions)
    assert torch.equal(plain.coord_predictions, full.coord_predictions)
    assert torch.equal(tr.coord_predictions, kw.coord_predictions)


def test_window_tracker_serves_pips2_at_any_s():
    model = _port(False)
    tracker = WindowTracker(model, iters=1, corr_mode="onehot", device="cpu")
    for S in (4, 6):
        xys, rgbs = _frames(S)
        trajs, vis = tracker(xys, rgbs)
        jtrajs, jvis = _jax_out(False, False, "onehot", S)
        np.testing.assert_allclose(trajs, jtrajs, rtol=0, atol=TRAJ_ATOL)
        np.testing.assert_allclose(vis, jvis, rtol=0, atol=VIS_ATOL)
        coords, vis_t, ffeat = tracker.track(tracker.encode(rgbs), xys)
        np.testing.assert_array_equal(coords.numpy(), trajs)
        assert ffeat.shape == (1, 12, 16)


def test_init_params_takes_pips2():
    model = init_params(Pips2(**TINY), seed=3)
    k = model.refiner.block0.tconv.kernel
    assert k.shape == (3, 1, 32)
    assert 0.3 < float(k.detach().std()) * np.sqrt(3.0) < 3.0  # LeCun-normal, fan-in 3
    assert float(model.refiner.block0.tconv.bias.detach().abs().max()) == 0.0
    assert float(model.refiner.final_norm.scale.detach().min()) == 1.0
    again = init_params(Pips2(**TINY), seed=3)
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n


def test_pips2_on_cpu_runs_the_plain_channel_block(monkeypatch):
    """With fused channel blocks, each block's forward is
    ``mixer_cuda.chan_ff_block`` at the refiner's width: on CPU tensors its
    plain version, once per block and iteration."""
    calls = []
    real = mixer_cuda.chan_ff_reference

    def spy(x, *a):
        calls.append(tuple(x.shape))
        return real(x, *a)

    monkeypatch.setattr(mixer_cuda, "chan_ff_reference", spy)
    _port_out(_port(True), 6, iters=2)
    assert calls == [(12 * 6, 32)] * (2 * TINY["refiner_depth"])


# ---- ChainTracker(S=): the S-agnostic window length, against JAX's

@functools.lru_cache(maxsize=None)
def _video():
    from pips_tpu.data import SyntheticPointDataset

    sample, _ = SyntheticPointDataset(S=9, N=5, H=64, W=96, seed=21)[0]
    return np.asarray(sample["rgbs"], np.float32), np.asarray(sample["trajs"][0], np.float32)


def fixed_skip(vis, S):
    return np.full(vis.shape[0], 3, np.int64)


@functools.lru_cache(maxsize=None)
def _jax_chain(S: int):
    rgbs, xys = _video()
    chain = JaxChainTracker(JaxPips2(**TINY), _params(False), iters=1, capacity=8,
                            corr_mode="onehot", S=S, select_fn=fixed_skip, record_starts=True)
    trajs, vis = chain.track_video(rgbs, xys)
    return trajs, vis, chain.last_window_starts


def test_chain_tracker_takes_s_like_jax():
    rgbs, xys = _video()
    jt, jv, jstarts = _jax_chain(6)
    chain = ChainTracker(_port(False), iters=1, capacity=8, corr_mode="onehot", S=6,
                         select_fn=fixed_skip, record_starts=True, device="cpu")
    assert chain.S == 6
    trajs, vis = chain.track_video(rgbs, xys)
    assert trajs.shape == jt.shape == (9, 5, 2) and vis.shape == jv.shape
    assert chain.last_window_starts == jstarts
    np.testing.assert_array_equal(trajs[0], xys)
    np.testing.assert_allclose(trajs, jt, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(vis, jv, rtol=0, atol=VIS_ATOL)
    assert np.abs(jt - xys[None]).max() > 5.0  # the points did move


def test_chain_tracker_window_length_defaults_like_jax():
    assert ChainTracker(_port(False), device="cpu").S == 8
    assert ChainTracker(Pips(S=4, latent_dim=16, mixer_dim=32, mixer_depth=2),
                        device="cpu").S == 4
