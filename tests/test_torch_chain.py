"""The port's chaining engines (inference.chain, inference.chain_device)
against the JAX package.

The skip rules are compared for exact equality. The trackers are compared on
the setup of tests/test_chain.py (TINY model, T=7 frames at 64x96, N=5,
iters=2, windows at 0, 3 and 6), with weights from the JAX init carried over
by convert.py and ``corr_mode="pallas"``: JAX runs its corr kernel in
interpret mode, the port its plain version. Tolerances follow the
"Numerical-chaos policy" of docs/TESTING.md: untrained weights amplify any
rounding difference through floor() at every refinement iteration, so

* f32: the first window within 0.05 px, every frame within 1 px and a median
  of 0.05 px, visibility within 0.05 (measured 0.0124 px, 0.583 px, 0.0063 px
  and 0.022, on points that move up to 36 px);
* bf16: JAX itself, run in bf16 and in f32, differs by up to 4.1 px (median
  0.79 px) here after two iterations, so the port in bf16 is held to twice
  JAX's own bf16-vs-f32 gap, max and median (measured 5.14 px and 0.92 px).
  One iteration is tight: the port and JAX differ by 0.17 px at most.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.data import SyntheticPointDataset
from pips_tpu.inference import ChainTracker as JaxChainTracker
from pips_tpu.inference import select_skip as jax_select_skip
from pips_tpu.inference.chain_device import select_skip_jnp
from pips_tpu.models import Pips as JaxPips
from pips_tpu_torch import ChainTracker, ChainTrackerOnDevice, Pips, make_pips, select_skip
from pips_tpu_torch.convert import load_flax_params
from pips_tpu_torch.inference import select_skip_torch

TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2,
            mixer_dim=32, mixer_depth=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes; one torch thread per
    worker keeps the tiny CPU ops of these tests from oversubscribing the
    cores (measured: a 0.6 s test took 48 s among six busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixed_skip(vis, S):
    return np.full(vis.shape[0], 3, np.int64)


@pytest.mark.parametrize("thr_init", [0.5, 0.8, 0.9, 0.99])
@pytest.mark.parametrize("thr_decay", [0.005, 0.02, 0.1])
def test_select_skip_equals_jax(thr_init, thr_decay):
    """The sweep of tests/test_chain.py, values injected at the decayed
    thresholds and at their one-ulp neighbours: exact equality."""
    rng = np.random.RandomState(hash((thr_init, thr_decay)) % 2**31)
    for S in (4, 6, 8):
        for si_earliest in (1, 2):
            vis = rng.rand(50, S).astype(np.float32)
            k = rng.randint(0, 6, size=(50, S))
            exact = (thr_init - k * thr_decay).astype(np.float32)
            ulp = np.spacing(exact) * rng.choice([-1, 0, 0, 1], size=(50, S))
            vis = np.where(rng.rand(50, S) < 0.4, exact + ulp, vis).astype(np.float32)
            kw = dict(S=S, thr_init=thr_init, thr_decay=thr_decay, si_earliest=si_earliest)
            np.testing.assert_array_equal(select_skip(vis, **kw), jax_select_skip(vis, **kw),
                                          err_msg=str(kw))


@pytest.mark.parametrize("S", [4, 8])
def test_select_skip_torch_equals_jnp(S):
    """The same f32 operations in the same order: exact equality, on random
    values and on values at the decayed thresholds and one ulp off them."""
    rng = np.random.RandomState(S)
    vis = rng.rand(400, S).astype(np.float32)
    exact = (0.9 - rng.randint(0, 8, size=(400, S)) * 0.02).astype(np.float32)
    ulp = np.spacing(exact) * rng.choice([-1, 0, 1], size=(400, S))
    vis[200:] = (exact + ulp)[200:].astype(np.float32)
    got = select_skip_torch(torch.from_numpy(vis), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(select_skip_jnp(jnp.asarray(vis), S)))


@functools.lru_cache(maxsize=None)
def _video():
    T, H, W, N = 7, 64, 96, 5
    sample, _ = SyntheticPointDataset(S=T, N=N, H=H, W=W, seed=21)[0]
    rgbs = np.asarray(sample["rgbs"], np.float32)
    xys = np.asarray(sample["trajs"][0], np.float32)
    params = JaxPips(**TINY).init(jax.random.PRNGKey(0), jnp.asarray(xys[None]),
                                  jnp.asarray(rgbs[None, :4]), iters=1)
    return rgbs, xys, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_chain_tracker(bf16: bool, corr_mode: str):
    """One tracker per configuration, so its jitted window compiles once."""
    model = JaxPips(**TINY, **(dict(dtype=jnp.bfloat16) if bf16 else {}))
    return JaxChainTracker(model, _video()[2], iters=2, capacity=8, corr_mode=corr_mode,
                           record_starts=True)


@functools.lru_cache(maxsize=None)
def _jax_chain(bf16: bool, rule: str, corr_mode: str = "pallas"):
    rgbs, xys, _ = _video()
    chain = _jax_chain_tracker(bf16, corr_mode)
    chain.select_fn = fixed_skip if rule == "fixed" else jax_select_skip
    with pltpu.force_tpu_interpret_mode():
        trajs, vis = chain.track_video(rgbs, xys)
    return trajs, vis, chain.last_window_starts


def _port_model(bf16: bool) -> Pips:
    m = Pips(**TINY, **(dict(dtype=torch.bfloat16) if bf16 else {}))
    return load_flax_params(m, _video()[2]).eval()


@pytest.mark.parametrize("corr_mode", ["pallas", "onehot"])
def test_chain_tracker_matches_jax_f32(corr_mode):
    rgbs, xys, _ = _video()
    jt, jv, _ = _jax_chain(False, "fixed", corr_mode)
    chain = ChainTracker(_port_model(False), iters=2, capacity=8, corr_mode=corr_mode,
                         select_fn=fixed_skip, device="cpu")
    trajs, vis = chain.track_video(rgbs, xys)
    assert trajs.shape == jt.shape and vis.shape == jv.shape
    np.testing.assert_array_equal(trajs[0], xys)
    d = np.abs(trajs - jt)
    assert d[:4].max() < 0.05 and d.max() < 1.0 and np.median(d) < 0.05, (
        d[:4].max(), d.max(), np.median(d))
    np.testing.assert_allclose(vis, jv, atol=0.05)


def test_chain_tracker_matches_jax_bf16():
    """bf16 maps: from the second window on, the carried features are f32 and
    the first iteration samples f32 targets against the bf16 pyramid."""
    rgbs, xys, _ = _video()
    jt, jv, _ = _jax_chain(True, "fixed")
    jt32 = _jax_chain(False, "fixed")[0]
    chain = ChainTracker(_port_model(True), iters=2, capacity=8, corr_mode="pallas",
                         select_fn=fixed_skip, device="cpu")
    trajs, vis = chain.track_video(rgbs, xys)
    np.testing.assert_array_equal(trajs[0], xys)
    d, gap = np.abs(trajs - jt), np.abs(jt - jt32)
    assert d.max() <= 2 * gap.max() and np.median(d) <= 2 * np.median(gap), (
        d.max(), np.median(d), gap.max(), np.median(gap))
    assert np.abs(vis - jv).max() < 0.25


def test_chain_tracker_visibility_rule_matches_jax():
    rgbs, xys, _ = _video()
    jt, jv, jstarts = _jax_chain(False, "vis")
    chain = ChainTracker(_port_model(False), iters=2, capacity=8, corr_mode="pallas",
                         record_starts=True, device="cpu")
    trajs, vis = chain.track_video(rgbs, xys)
    assert chain.last_window_starts == jstarts
    d = np.abs(trajs - jt)
    assert d.max() < 1.0 and np.median(d) < 0.05, (d.max(), np.median(d))
    np.testing.assert_allclose(vis, jv, atol=0.05)


@pytest.mark.parametrize("bf16", [False, True])
def test_on_device_chain_matches_host(bf16):
    """Same windows, the same features and the same f32 frame-0 appearance
    features, batched the same way (a fixed skip moves every point together),
    so the trajectories agree; visibility differs only by the sigmoid's
    rounding (1/(1+exp(-x)) on the host). Measured: equal, and 1.2e-7."""
    rgbs, xys, _ = _video()
    model = _port_model(bf16)
    host = ChainTracker(model, iters=2, capacity=8, corr_mode="pallas", select_fn=fixed_skip,
                        device="cpu")
    ht, hv = host.track_video(rgbs, xys)
    dev = ChainTrackerOnDevice(model, iters=2, corr_mode="pallas", fixed_skip=3, device="cpu")
    dt, dv = dev.track_video(rgbs, xys)
    assert dt.shape == ht.shape and dv.shape == hv.shape
    np.testing.assert_allclose(dt, ht, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dv, hv, rtol=0, atol=1e-5)


def test_on_device_chain_visibility_rule_and_max_starts():
    rgbs, xys, _ = _video()
    model = _port_model(False)
    host = ChainTracker(model, iters=2, capacity=8, record_starts=True, device="cpu")
    ht, hv = host.track_video(rgbs, xys)
    dt, dv = ChainTrackerOnDevice(model, iters=2, device="cpu").track_video(rgbs, xys)
    np.testing.assert_allclose(dt, ht, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dv, hv, rtol=0, atol=1e-5)
    # one start: only the first window is written, the rest stays zero
    ot, ov = ChainTrackerOnDevice(model, iters=2, max_starts=1, device="cpu").track_video(
        rgbs, xys)
    np.testing.assert_allclose(ot[:4], ht[:4], rtol=0, atol=1e-4)
    assert not ot[4:].any() and not ov[4:].any()


def test_track_stream_equals_track_video_with_eviction():
    """Online chaining equals offline exactly, and holds a bounded number of
    feature chunks: 25 frames are 7 chunks of 4; a window spans at most 2 and
    the encode lookahead adds one."""
    model = make_pips(device="cpu", seed=3, **TINY)
    rng = np.random.RandomState(3)
    rgbs = (rng.rand(25, 64, 96, 3) * 255).astype(np.float32)
    xys = (rng.rand(4, 2) * [80, 48] + 8).astype(np.float32)
    chain = ChainTracker(model, iters=1, encode_chunk=4, corr_mode="pallas", device="cpu")
    t_off, v_off = chain.track_video(rgbs, xys)
    t_on, v_on = chain.track_stream((f for f in rgbs), xys)
    np.testing.assert_array_equal(t_off, t_on)
    np.testing.assert_array_equal(v_off, v_on)
    assert 1 <= chain.stream_peak_chunks <= 3, chain.stream_peak_chunks


@pytest.mark.parametrize("skip", [0, 4])
def test_select_fn_contract_violation_raises(skip):
    model = make_pips(device="cpu", seed=0, **TINY)
    rgbs = (np.random.RandomState(0).rand(7, 32, 48, 3) * 255).astype(np.float32)
    bad = lambda vis, S: np.full(vis.shape[:-1], skip, np.int64)  # outside [1, S-1]
    chain = ChainTracker(model, iters=1, select_fn=bad, device="cpu")
    with pytest.raises(ValueError, match="select_fn"):
        chain.track_video(rgbs, np.array([[20.0, 12.0]], np.float32))
