"""The join of the port's spans with the device trace (``portbench/spans.py``)
on canned events, the span metrics' readers, and on the card the clock the
spans share with the trace."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import spans, spec, trace

SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
STREAM = 7


class Kineto:
    """The part of a ``torch.profiler`` event that ``spans.device_ops`` reads."""

    def __init__(self, name, cuda, corr, start, dur, res):
        self._v = (name, cuda, corr, start, dur, res)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


# One step (ns on the shared clock): the spans as the port records them.
SPANS = [("step.forward", 1, 110, 400), ("step.backward", 1, 410, 900),
         ("step.optimizer", 1, 905, 995), ("step", 0, 100, 1000)]
MAIN, AUTOGRAD = 1111, 2222  # the threads' ids


def canned_profile():
    """Kernels on one stream, each after its launch record: the forward's from
    the caller's thread, the backward's from the autograd engine's, a memcpy,
    a kernel whose launch the trace lacks, the optimizer's; the marks around
    the step launched outside it. Overhead records share a correlation id with
    a launch and come before it."""
    ev = []

    def op(name, corr, launch, start, end, thread=MAIN, api="cudaLaunchKernel"):
        if launch is not None:
            ev.append(Kineto(api, False, corr, launch, 5, thread))
        ev.append(Kineto(name, True, corr, start, end - start, STREAM))

    op(SPIN, 1, 90, 200, 201)
    ev.append(Kineto("Activity Buffer Request", False, 2, 50, 40, 0))
    op("fwd_kernel", 2, 150, 300, 400)
    op("bwd_kernel", 3, 500, 500, 700, thread=AUTOGRAD, api="cudaLaunchKernelExC")
    op("Memcpy DtoD (Device -> Device)", 4, 420, 700, 750, thread=AUTOGRAD,
       api="cudaMemcpyAsync")
    op("bwd_unlaunched", 5, None, 800, 900)
    op("adam_kernel", 6, 950, 1200, 1300)
    op(SPIN, 7, 1005, 3000, 3001)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))


def test_device_ops_take_their_launch_by_correlation_id():
    ops = spans.device_ops(canned_profile())
    assert [(o.name, o.launch) for o in ops] == [
        (SPIN, 90), ("fwd_kernel", 150), ("bwd_kernel", 500),
        ("Memcpy DtoD (Device -> Device)", 420), ("bwd_unlaunched", None),
        ("adam_kernel", 950), (SPIN, 1005)]
    assert [o.cat for o in ops][1:5] == ["kernel", "kernel", "memcpy", "kernel"]
    assert {o.stream for o in ops} == {STREAM}


def test_ops_are_attributed_by_their_launch_from_any_thread():
    t = spans.join(spans.device_ops(canned_profile()), SPANS, units=1)
    got = {k: (round(v["dev_ms"] * 1e6), v["ops"]) for k, v in t["spans"].items()}
    # the backward's kernel came from another thread; the unlaunched kernel
    # takes the host time of the memcpy before it on its stream
    assert got == {"step": (500, 5), "step.forward": (100, 1), "step.backward": (300, 3),
                   "step.optimizer": (100, 1)}
    assert t["unlaunched"] == 1 and t["ops"] == 5
    top = {k: [(name, round(ms * 1e6)) for name, ms in v] for k, v in t["top"].items()}
    assert top == {"step.forward": [("fwd_kernel", 100)],
                   "step.backward": [("bwd_kernel", 200), ("bwd_unlaunched", 100)],
                   "step.optimizer": [("adam_kernel", 100)]}
    assert t["spans"]["step"]["host_ms"] == pytest.approx(900e-6)


def test_a_kernel_without_a_launch_first_on_its_stream_is_attributed_nowhere():
    ops = [spans.Op(SPIN, "kernel", 0, 1, STREAM, 0),
           spans.Op("orphan", "kernel", 10, 20, 3, None),
           spans.Op(SPIN, "kernel", 30, 31, STREAM, 40)]
    t = spans.join(ops, [("step", 0, 5, 35)], units=1)
    assert t["spans"]["step"]["ops"] == 0 and t["unlaunched"] == 1


def test_idle_splits_by_the_innermost_open_span_and_sums_to_the_sections_idle():
    ops = spans.device_ops(canned_profile())
    t = spans.join(ops, SPANS, units=1)
    idle = {k: round(v["idle_ms"] * 1e6) for k, v in t["spans"].items()}
    assert idle == {"step.forward": 100, "step": 20, "step.backward": 140,
                    "step.optimizer": 90}
    assert round(t["outside_idle_ms"] * 1e6) == 1901
    assert sum(idle.values()) + round(t["outside_idle_ms"] * 1e6) == round(t["idle_ms"] * 1e6)
    # trace.reduce's union over the same operations (times taken as its microseconds)
    red = trace.reduce([trace.Event(o.name, o.cat, o.start, o.end) for o in ops], ("call",), 1)
    assert t["idle_ms"] == pytest.approx(red["window_s"] - red["busy_s"])
    assert t["window_ms"] == pytest.approx(red["window_s"])


def test_a_span_begun_later_on_another_thread_is_the_innermost():
    """A recompute span opened on the autograd engine's thread (depth 0 there)
    inside the caller's ``step.backward`` takes the idle time it covers."""
    ops = [spans.Op(SPIN, "kernel", 0, 1, STREAM, 0), spans.Op(SPIN, "kernel", 100, 101, STREAM, 0)]
    rec = [("mixer.token", 0, 40, 60), ("step.backward", 1, 10, 90), ("step", 0, 5, 95)]
    t = spans.join(ops, rec, units=1)
    idle = {k: round(v["idle_ms"] * 1e6) for k, v in t["spans"].items()}
    assert idle == {"mixer.token": 20, "step.backward": 60, "step": 10}
    assert round(t["outside_idle_ms"] * 1e6) == 11


def test_join_refuses_a_section_that_lost_a_mark():
    ops = [spans.Op(SPIN, "kernel", 0, 1, STREAM, 0)]
    with pytest.raises(ValueError, match="expected 2 marks"):
        spans.join(ops, [], units=1)


READERS = [
    ("input_host_ms.serve", "window", "window.input", "host_ms"),
    ("encode_dev_ms.serve", "window", "pips.encode", "dev_ms"),
    ("track_dev_ms.serve", "window", "pips.track", "dev_ms"),
    ("corr_dev_ms.serve", "window", "track.corr", "dev_ms"),
    ("token_mix_dev_ms.serve", "window", "mixer.token", "dev_ms"),
    ("idle_encode_ms.serve", "window", "pips.encode", "idle_ms"),
    ("step_host_ms.train", "train_step", "step", "host_ms"),
    ("forward_dev_ms.train", "train_step", "step.forward", "dev_ms"),
    ("backward_dev_ms.train", "train_step", "step.backward", "dev_ms"),
    ("launches.train", "train_step", "step", "ops"),
    ("idle_optimizer_ms.train", "train_step", "step.optimizer", "idle_ms"),
]


@pytest.mark.parametrize("metric,kind,span,key", READERS, ids=[r[0] for r in READERS])
def test_span_readers_read_their_span_and_none_without_spans(metric, kind, span, key):
    names = {s for _, _, s, _ in READERS}
    table = {"units": 2, "outside_idle_ms": 0.5,
             "spans": {s: {"host_ms": 1.0 + i, "dev_ms": 10.0 + i, "ops": 100.0 + i,
                           "idle_ms": 0.1 * i} for i, s in enumerate(sorted(names))}}
    reader = spec.reader(metric)
    other = "train_step" if kind == "window" else "window"
    assert reader.read({"kind": kind, "trace": {"calls": {}, "spans": table}}) == \
        table["spans"][span][key]
    assert reader.read({"kind": other, "trace": {"calls": {}, "spans": table}}) is None
    assert reader.read({"kind": kind, "trace": {"calls": {}, "parts": {}}}) is None
    assert reader.read({"kind": kind, "trace": None}) is None


@pytest.mark.chip
def test_spans_contain_their_kernels_on_the_card():
    """100 of 100 spans, each opened before a spin kernel's launch and closed
    after a sync, contain that kernel's device interval and its launch record
    on the profiler's clock; prints the smallest margin at each end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from pips_tpu_torch.utils import spans as port_spans
    from torch.profiler import ProfilerActivity

    tries = 100
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        with port_spans.recording() as rec:
            for _ in range(tries):
                with port_spans.span("sleep"):
                    torch.cuda._sleep(20000)
                    torch.cuda.synchronize()
                time.sleep(0.001)
    kernels = sorted((o for o in spans.device_ops(prof) if trace.MARK.search(o.name)),
                     key=lambda o: o.start)
    assert len(kernels) == len(rec) == tries
    margins = [(o.start - b, e - o.end, o.launch - b, e - o.launch)
               for o, (_, _, b, e) in zip(kernels, sorted(rec, key=lambda s: s[2]))]
    low = [min(m[i] for m in margins) for i in range(4)]
    print(f"clock check: {tries} of {tries} spans; smallest margins (ns): kernel begin "
          f"{low[0]}, kernel end {low[1]}, launch begin {low[2]}, launch end {low[3]}")
    assert min(low) > 0
