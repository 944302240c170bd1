"""Reduce a profiled span to device time by part and by kernel name.

The benchmark profiles a few windows or steps with device activity only:
recording every host operation as well doubled a training step's wall time
on the card, and the idle share read from such a span measured the
profiler. So the units (whole windows or steps) and the parts of a split unit
(encode, track; or forward, backward, optimizer) are told apart on the
device itself: ``mark`` launches a one-microsecond spin kernel before
each part and after the last, and the span runs from the first mark to the
last. The profiler has been seen to drop the first or last kernels of a
trace, so ``pad`` runs a few other kernels outside the marks. A device
operation belongs to the part whose mark came last before it (as
``pips_tpu_torch/profile_window.py:summarize``, commit 58c35d9, assigns
kernels to ranges). Busy time is the union of the operations' intervals
inside the span; the span's wall time comes from the same trace, so the
idle share has one source. ``from_profiler`` turns a ``torch.profiler`` run
into plain events; everything else here works on those, so the reduction is
testable without a card.
"""

from __future__ import annotations

import dataclasses
import re

MARK = re.compile(r"spin_kernel")
MARK_CYCLES = 2000


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str      # "kernel", "memcpy" or "memset"
    start: float  # microseconds on the device's trace clock
    end: float


def mark() -> None:
    import torch

    torch.cuda._sleep(MARK_CYCLES)


def pad(device) -> None:
    """A few kernels that are no mark, a sync, and 20 ms for the profiler to
    take in what came before."""
    import time

    import torch

    x = torch.zeros(16, device=device)
    for _ in range(4):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    time.sleep(0.02)


def from_profiler(prof) -> list:
    """The device operations of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith(("Optimizer.", "ProfilerStep")):
            continue
        cat = ("memcpy" if e.name.startswith("Memcpy") else
               "memset" if e.name.startswith("Memset") else "kernel")
        out.append(Event(e.name, cat, e.time_range.start, e.time_range.end))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list, parts, units: int, top: int = 10) -> dict:
    """``units`` windows or steps, each of the ``parts`` in order, each part
    opened by a mark and the last closed by one. Per unit: device kernel ms
    by part, copy ms; over the span: seconds and counts by kernel name, busy
    and wall seconds, and the longest idle gaps named by their part."""
    marks = sorted((e for e in events if MARK.search(e.name)), key=lambda e: e.start)
    want = units * len(parts) + 1
    if len(marks) != want:
        raise ValueError(f"expected {want} marks in the trace, found {len(marks)}")
    w0, w1 = marks[0].start, marks[-1].end
    bounds = [m.start for m in marks]
    names = [parts[i % len(parts)] for i in range(want - 1)]

    def part_at(t):
        i = 0
        while i + 1 < len(bounds) - 1 and bounds[i + 1] <= t:
            i += 1
        return names[i]

    ops = [e for e in events if not MARK.search(e.name) and e.end > w0 and e.start < w1]
    by_part, by_name, copy_us = {}, {}, 0.0
    for e in ops:
        us = e.end - e.start
        if e.cat == "memcpy":
            copy_us += us
        s = by_name.setdefault(e.name, [0.0, 0])
        s[0] += us
        s[1] += 1
        if e.cat == "kernel":
            p = part_at(e.start)
            by_part[p] = by_part.get(p, 0.0) + us
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in ops)
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((part_at(t), (s - t) / 1e6))
        t = max(t, e)
    gaps.sort(key=lambda g: -g[1])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "units": units,
        "kernel_ms_by_part": {k: v / 1e3 / units for k, v in by_part.items()},
        "copy_ms": copy_us / 1e3 / units,
        "kernels": {k: {"s": v[0] / 1e6, "count": v[1]} for k, v in by_name.items()},
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[k[:100], v[0] / 1e6] for k, v in ranked[:top]],
        "idle_gaps": [[name, s] for name, s in gaps[:top]],
    }


def sections(events: list, plan) -> list:
    """Split one trace into its sections, ``plan`` listing (parts, units) of
    each in the order run, and ``reduce`` each between its own marks."""
    marks = sorted((e for e in events if MARK.search(e.name)), key=lambda e: e.start)
    want = [units * len(parts) + 1 for parts, units in plan]
    if len(marks) != sum(want):
        raise ValueError(f"expected {sum(want)} marks in the trace, found {len(marks)}")
    out, k = [], 0
    for (parts, units), n in zip(plan, want):
        own = marks[k:k + n]
        w0, w1 = own[0].start, own[-1].end
        ops = [e for e in events if not MARK.search(e.name) and e.end > w0 and e.start < w1]
        out.append(reduce(ops + own, parts, units))
        k += n
    return out


def profiled(device, plan, attempts: int = 3) -> list:
    """Run ``plan``'s sections, each (parts, units, one), in one profiler
    session (device activity only) and reduce each. A section first runs one
    unit unmarked (``one(-1, part)`` for each part: the profiler's first
    sight of a kernel costs the host time), then ``units`` units with a mark
    before each part and after the last. The marks sit in the stream's
    order, so ``one`` need not sync; the split sections sync after each
    part, as the port's profilers did, and the whole calls do not. A session
    that lost a mark runs again, up to ``attempts`` times."""
    import sys

    import torch
    from torch.profiler import ProfilerActivity

    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad(device)
            for parts, units, one in plan:
                for part in parts:
                    one(-1, part)
                pad(device)
                for i in range(units):
                    for part in parts:
                        mark()
                        one(i, part)
                mark()
                pad(device)
        try:
            return sections(from_profiler(prof), [(parts, units) for parts, units, _ in plan])
        except ValueError as e:
            print(f"portbench: profile attempt {attempt} of {attempts}: {e}", file=sys.stderr)
    raise ValueError(f"every profile attempt lost a mark ({attempts})")


def per_call_us(kernels: dict, patterns, calls: int):
    """Device microseconds of one call of a block that launches one kernel of
    each of ``patterns`` (compiled regexes) a call: each pattern's time over
    its own launch count, summed. The profiler on the card has been seen to
    drop some kernel events, so each kernel is averaged over the launches it
    kept. None where a pattern matched no kernel, or kept more launches than
    the ``calls`` made."""
    total = 0.0
    for pat in patterns:
        hits = [v for k, v in kernels.items() if pat.search(k)]
        count = sum(v["count"] for v in hits)
        if count == 0 or count > calls:
            return None
        total += sum(v["s"] for v in hits) * 1e6 / count
    return total
