"""The port's span recorder (``pips_tpu_torch.utils.spans``) and the spans
placed in the window tracker, the model and the train step, on the CPU at
TINY widths: what they record, how they nest, that recording changes no
output, and that they share the profiler's clock."""

import threading

import numpy as np
import pytest
import torch

from pips_tpu_torch import WindowTracker, make_pips
from pips_tpu_torch.data import SyntheticPointDataset
from pips_tpu_torch.train import make_optimizer, make_train_step
from pips_tpu_torch.utils import spans

TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)
ITERS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(seed: int = 3):
    return SyntheticPointDataset(S=4, N=8, H=64, W=96, seed=seed)[0][0]


def _window_inputs():
    c = _clip()
    return c["trajs"][None, 0].astype(np.float32), c["rgbs"][None].astype(np.float32)


def _train_batch(grad_acc: int):
    """One clip a microbatch: (grad_acc, 1, ...) arrays, or (1, ...) for one."""
    clips = [_clip(seed) for seed in range(3, 3 + grad_acc)]
    batch = {k: np.stack([c[k] for c in clips])[:, None].astype(np.float32)
             for k in ("rgbs", "trajs", "visibles", "valids")}
    return batch if grad_acc > 1 else {k: v[0] for k, v in batch.items()}


def _nested(rec):
    """The spans sorted by begin, each checked to lie inside the last open
    span one level up; returns (name, depth) in order."""
    order = sorted(rec, key=lambda s: (s[2], s[1]))
    stack = []
    for name, depth, b, e in order:
        assert b <= e, name
        while stack and stack[-1][1] >= depth:
            stack.pop()
        assert len(stack) == depth, (name, depth, [s[0] for s in stack])
        if stack:
            assert stack[-1][2] <= b and e <= stack[-1][3], (name, stack[-1][0])
        stack.append((name, depth, b, e))
    return [(name, depth) for name, depth, _, _ in order]


def test_span_off_is_one_shared_object_and_records_nothing():
    assert spans.span("window") is spans.span("pips.track")
    with spans.span("window") as inside:
        assert inside is None
    with spans.recording() as rec:
        with spans.span("a"):
            with spans.span("b"):
                pass
        with pytest.raises(RuntimeError, match="already open"):
            with spans.recording():
                pass
    with spans.span("c"):
        pass
    assert [(n, d) for n, d, _, _ in rec] == [("b", 1), ("a", 0)]
    assert spans.span("window") is spans.span("c")


def test_depth_is_kept_per_thread():
    """A span opened on another thread while one is open here starts at depth
    0 there, as a recompute on the autograd engine's thread does."""
    with spans.recording() as rec:
        with spans.span("caller"):
            worker = threading.Thread(target=_one_span, args=("worker",))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    assert sorted((n, d) for n, d, _, _ in rec) == [("caller", 0), ("worker", 0)]


def _one_span(name):
    with spans.span(name):
        pass


def test_window_records_its_spans_nested_in_order():
    model = make_pips(device="cpu", seed=0, **TINY)
    tracker = WindowTracker(model, iters=ITERS, device="cpu")
    xys, rgbs = _window_inputs()
    with spans.recording() as rec:
        tracker(xys, rgbs)
    block = [("mixer.token", 2)] * TINY["mixer_depth"]
    want = ([("window", 0), ("window.input", 1), ("pips.encode", 1), ("pips.track", 1)]
            + [("track.corr", 2), *block] * ITERS)
    assert _nested(rec) == want
    assert len(rec) == 4 + ITERS * (1 + TINY["mixer_depth"])


@pytest.mark.parametrize("grad_acc", [1, 2])
def test_train_step_records_its_spans_nested_in_order(grad_acc):
    model = make_pips(device="cpu", seed=0, **TINY).train()
    opt = make_optimizer(model.parameters(), 3e-4, 8)
    step = make_train_step(model, opt, iters=ITERS, horz_flip=True, vert_flip=False,
                           grad_acc=grad_acc)
    with spans.recording() as rec:
        step(_train_batch(grad_acc))
    track = [("pips.track", 2)] + [("track.corr", 3), *[("mixer.token", 3)] * TINY[
        "mixer_depth"]] * ITERS
    micro = [("step.forward", 1), ("pips.encode", 2), *track, ("step.backward", 1)]
    assert _nested(rec) == [("step", 0)] + micro * grad_acc + [("step.optimizer", 1)]


def test_outputs_are_bit_for_bit_the_same_with_recording_on():
    xys, rgbs = _window_inputs()
    tracker = WindowTracker(make_pips(device="cpu", seed=0, **TINY), iters=ITERS, device="cpu")
    off = tracker(xys, rgbs)
    with spans.recording():
        on = tracker(xys, rgbs)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)

    def two_steps(record: bool):
        model = make_pips(device="cpu", seed=0, **TINY).train()
        step = make_train_step(model, make_optimizer(model.parameters(), 3e-4, 8), iters=ITERS,
                               horz_flip=True, vert_flip=False, grad_acc=2)
        if record:
            with spans.recording():
                metrics = [step(_train_batch(2)) for _ in range(2)]
        else:
            metrics = [step(_train_batch(2)) for _ in range(2)]
        return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}

    (m_off, p_off), (m_on, p_on) = two_steps(False), two_steps(True)
    assert m_off == m_on
    for k in p_off:
        assert torch.equal(p_off[k], p_on[k]), k


def test_spans_share_the_profilers_clock():
    """A ``record_function`` range opened inside a span, as the profiler
    stamps it, lies inside the span's [begin_ns, end_ns]."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            for _ in range(5):
                with spans.span("outer"):
                    with record_function("inner"):
                        torch.ones(64).add_(1.0)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "inner")
    assert len(ranges) == len(rec) == 5
    for (b, e), (_, _, sb, se) in zip(ranges, sorted(rec, key=lambda s: s[2])):
        assert sb <= b and e <= se, (sb, b, e, se)
