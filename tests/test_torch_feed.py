"""The port's FrameFeed (inference.feed): chunking protocol, and the port's
chaining engines fed by it. Mirrors tests/test_feed.py, and holds the port's
copy of the feed to the JAX package's chunk for chunk.

Engine tests use the port alone, at TINY width on the CPU; a feed and an
array of the same frames must give exactly equal results.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pips_tpu.inference.feed import FrameFeed as JaxFrameFeed
from pips_tpu_torch import ChainTracker, ChainTrackerOnDevice, FrameFeed, as_feed, make_pips
from pips_tpu_torch.inference.feed import _ArrayChunks

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


def _video(T, H=16, W=24, seed=0):
    return (np.random.RandomState(seed).rand(T, H, W, 3) * 255).astype(np.float32)


@pytest.mark.parametrize("T,chunk", [(8, 4), (7, 4), (3, 8), (5, 5), (1, 4)])
def test_feed_matches_array_chunks(T, chunk):
    rgbs = _video(T)
    got = list(FrameFeed(list(rgbs), chunk=chunk))
    want = list(_ArrayChunks(rgbs, chunk))
    assert len(got) == len(want)
    for (gc, gn), (wc, wn) in zip(got, want):
        assert gn == wn and gc.shape == wc.shape
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("T,chunk", [(7, 4), (3, 8)])
def test_feed_matches_jax_feed(T, chunk):
    rgbs = _video(T, seed=T)
    got = list(FrameFeed(list(rgbs), chunk=chunk))
    want = list(JaxFrameFeed(list(rgbs), chunk=chunk))
    assert [n for _, n in got] == [n for _, n in want]
    for (gc, _), (wc, _) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)


def test_feed_tail_padding_repeats_last_frame():
    rgbs = _video(6)
    c, n = list(FrameFeed(list(rgbs), chunk=4))[-1]
    assert n == 2
    np.testing.assert_array_equal(c[2], rgbs[5])
    np.testing.assert_array_equal(c[3], rgbs[5])


def test_feed_lazy_callables_and_transform_run_on_feed_thread():
    rgbs = _video(5)
    seen_threads = set()

    def lazy(i):
        def load():
            seen_threads.add(threading.current_thread().name)
            return rgbs[i]
        return load

    out = np.concatenate([c[:n] for c, n in
                          FrameFeed([lazy(i) for i in range(5)], chunk=4,
                                    transform=lambda f: f * 2.0)], 0)
    np.testing.assert_allclose(out, rgbs * 2.0)
    assert "MainThread" not in seen_threads  # decode happened off-thread


def test_feed_propagates_decode_error_at_the_failing_chunk():
    def boom():
        raise IOError("corrupt frame")

    frames = [lambda: _video(1)[0]] * 4 + [boom]
    it = iter(FrameFeed(frames, chunk=4))
    c, n = next(it)  # the first chunk decoded fine and arrives
    assert n == 4
    with pytest.raises(IOError, match="corrupt frame"):
        next(it)


def test_as_feed_passthrough_and_validation():
    rgbs = _video(4)
    feed = FrameFeed(list(rgbs), chunk=2)
    assert as_feed(feed, chunk=8) is feed  # the feed's own chunk wins
    assert isinstance(as_feed(rgbs, chunk=8), _ArrayChunks)
    assert isinstance(as_feed(iter(rgbs), chunk=8), FrameFeed)
    with pytest.raises(ValueError):
        list(_ArrayChunks(rgbs[0], 4))  # not (T, H, W, C)
    with pytest.raises(ValueError):
        FrameFeed(list(rgbs), chunk=0)


def test_feed_is_single_use():
    feed = FrameFeed(list(_video(4)), chunk=4)
    list(feed)
    with pytest.raises(RuntimeError, match="single-use"):
        list(feed)


def test_feed_close_releases_blocked_producer():
    feed = FrameFeed(list(_video(40)), chunk=4, depth=1)  # producer blocks on put
    it = iter(feed)
    next(it)      # consume one chunk, then abandon
    it.close()    # generator finally -> feed.close()
    t0 = time.time()
    feed._thread.join(timeout=5.0)
    assert not feed._thread.is_alive() and time.time() - t0 < 5.0


@pytest.fixture(scope="module")
def tiny_setup():
    model = make_pips(device="cpu", seed=0, **TINY)
    rng = np.random.RandomState(7)
    rgbs = (rng.rand(7, 64, 96, 3) * 255).astype(np.float32)
    xys = (rng.rand(3, 2) * [80, 48] + 8).astype(np.float32)
    return model, rgbs, xys


def test_chain_tracker_accepts_feed(tiny_setup):
    model, rgbs, xys = tiny_setup
    chain = ChainTracker(model, iters=1, encode_chunk=4, device="cpu")
    t_a, v_a = chain.track_video(rgbs, xys)
    t_f, v_f = chain.track_video(FrameFeed(list(rgbs), chunk=4), xys)
    np.testing.assert_array_equal(t_a, t_f)
    np.testing.assert_array_equal(v_a, v_f)


def test_on_device_tracker_accepts_feed(tiny_setup):
    model, rgbs, xys = tiny_setup
    chain = ChainTrackerOnDevice(model, iters=1, device="cpu")
    t_a, v_a = chain.track_video(rgbs, xys)
    t_f, v_f = chain.track_video(FrameFeed(list(rgbs), chunk=8), xys)
    np.testing.assert_array_equal(t_a, t_f)
    np.testing.assert_array_equal(v_a, v_f)


def test_track_stream_equals_track_video(tiny_setup):
    model, rgbs, xys = tiny_setup
    chain = ChainTracker(model, iters=1, encode_chunk=4, device="cpu")
    t_off, v_off = chain.track_video(rgbs, xys)
    t_arr, v_arr = chain.track_stream(rgbs, xys)  # array input
    np.testing.assert_array_equal(t_off, t_arr)
    np.testing.assert_array_equal(v_off, v_arr)
    assert chain.stream_peak_chunks <= 2  # 7 frames / chunk 4 -> 2 chunks in all
    t_f, v_f = chain.track_stream(FrameFeed(list(rgbs), chunk=4), xys)
    np.testing.assert_array_equal(t_off, t_f)
    np.testing.assert_array_equal(v_off, v_f)


def test_track_stream_with_mismatched_feed_chunk(tiny_setup):
    """A caller-built FrameFeed's own chunk size wins over encode_chunk."""
    model, rgbs, xys = tiny_setup
    chain = ChainTracker(model, iters=1, encode_chunk=4, device="cpu")
    t_off, v_off = chain.track_video(rgbs, xys)
    t_on, v_on = chain.track_stream(FrameFeed(list(rgbs), chunk=3), xys)
    np.testing.assert_array_equal(t_off, t_on)
    np.testing.assert_array_equal(v_off, v_on)


def test_track_stream_rejects_empty_stream(tiny_setup):
    model, _, xys = tiny_setup
    chain = ChainTracker(model, iters=1, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        chain.track_stream(iter([]), xys)
