"""The port's own spans laid over the device trace: device time, operations
and idle time by the part of the program that was running on the host.

The port marks its parts with ``pips_tpu_torch.utils.spans`` (``window``,
``window.input``, ``pips.encode``, ``pips.track``, ``track.corr``,
``mixer.token``; ``step``, ``step.forward``, ``step.backward``,
``step.optimizer``). The spans and the profiler's events share one clock,
Unix nanoseconds on the host. ``profiled`` runs a cell's profiled sections
as ``trace.profiled`` does and appends one more: the first section's whole
units again, each inside ``spans.recording()``. ``join`` turns that
section into a table, per unit:

* ``host_ms``: the host time inside the span;
* ``dev_ms`` and ``ops``: the device kernel time (as ``kernel_ms_by_part``)
  and the device operations (kernels, copies, memsets) *launched* while the
  span was open, nested spans included. Each operation is matched to its
  CUDA runtime or driver launch record by correlation id, and the launch's
  host time places it, whichever thread launched it (the autograd engine
  launches the backward from its own). An operation whose launch the trace
  lacks takes the host time of the operation before it on its stream;
* ``idle_ms``: the device-idle time (the same union of operations between
  the section's marks as ``trace.reduce``) while the span was the innermost
  one open on the host (the open span begun last), with ``outside`` for
  the harness's time between units.

Besides, ``top`` lists for each span the kernels that take most device time
among those launched while it was the innermost open span.

``python3 -m portbench.spans --workload <cell> --seed <n> [--seconds <s>]``
runs a cell on the card as ``portbench.run --trace 1`` does (the timed
window, the profiled sections, the check), with the spans section
appended, prints the span table to standard error, and as its last line a
JSON object with every metric whose reader under ``metrics/`` finds
something in that record. The benchmark's own runs do not run it: its
traffic kinds (``traffic/*.py``) profile no spans section yet, so the span
metrics read None there.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

from portbench import trace

LAUNCH = re.compile(r"^cu(da)?[A-Z]")  # runtime (cudaLaunchKernel) or driver (cuLaunchKernel)
OUTSIDE = "outside"
TOP = 5  # kernels listed a span


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    cat: str       # "kernel", "memcpy" or "memset"
    start: int     # nanoseconds, device
    end: int
    stream: int
    launch: int | None  # nanoseconds, host; None where the trace lacks the launch


def device_ops(prof) -> list:
    """The device operations of a finished ``torch.profiler.profile``, each
    with the host time of its launch record where the trace holds one."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != DeviceType.CUDA and LAUNCH.match(e.name())}
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        cat = ("memcpy" if name.startswith("Memcpy") else
               "memset" if name.startswith("Memset") else "kernel")
        out.append(Op(name, cat, e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.device_resource_id(), launches.get(e.correlation_id())))
    return out


def _host_times(ops: list) -> list:
    """Each op's launch time, or that of the op before it on its stream."""
    last, out = {}, [None] * len(ops)
    for i in sorted(range(len(ops)), key=lambda i: ops[i].start):
        t = ops[i].launch if ops[i].launch is not None else last.get(ops[i].stream)
        out[i] = last[ops[i].stream] = t
    return out


def _innermost(spans: list) -> list:
    """(begin, end, name) pieces of the host timeline, each under one
    innermost open span (the open one begun last), in order."""
    cuts = sorted({t for s in spans for t in (s[2], s[3])})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [s for s in spans if s[2] <= a and b <= s[3]]
        if open_:
            pieces.append((a, b, max(open_, key=lambda s: (s[2], s[1]))[0]))
    return pieces


def _idle_by_span(gaps: list, pieces: list) -> dict:
    """Nanoseconds of each gap under each piece's span, the rest ``outside``."""
    out = {}
    starts = [p[0] for p in pieces]
    for g0, g1 in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(pieces) and pieces[i][0] < g1:
            a, b, name = pieces[i]
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap
                covered += overlap
            i += 1
        out[OUTSIDE] = out.get(OUTSIDE, 0) + (g1 - g0) - covered
    return out


def join(ops: list, spans: list, units: int) -> dict:
    """The span table of one section: ``ops`` its device operations, the
    marks (``trace.MARK``) among them opening each unit and closing the last,
    and ``spans`` the ``(name, depth, begin_ns, end_ns)`` recorded meanwhile."""
    marks = sorted((o for o in ops if trace.MARK.search(o.name)), key=lambda o: o.start)
    if len(marks) != units + 1:
        raise ValueError(f"expected {units + 1} marks in the spans section, found {len(marks)}")
    w0, w1 = marks[0].start, marks[-1].end
    ops = [o for o in ops if not trace.MARK.search(o.name) and o.end > w0 and o.start < w1]
    host = _host_times(ops)
    order = sorted((t, i) for i, t in enumerate(host) if t is not None)
    times = [t for t, _ in order]
    launched, host_ns = {}, {}
    for name, _, b, e in spans:
        host_ns[name] = host_ns.get(name, 0) + (e - b)
        lo, hi = bisect.bisect_left(times, b), bisect.bisect_right(times, e)
        launched.setdefault(name, set()).update(i for _, i in order[lo:hi])
    busy = trace._union((max(o.start, w0), min(o.end, w1)) for o in ops)
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    pieces = _innermost(spans)
    idle = _idle_by_span(gaps, pieces)
    top = {}
    starts = [p[0] for p in pieces]
    for o, t in zip(ops, host):
        if o.cat != "kernel" or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        name = pieces[i][2] if i >= 0 and t <= pieces[i][1] else OUTSIDE
        by_kernel = top.setdefault(name, {})
        by_kernel[o.name] = by_kernel.get(o.name, 0) + (o.end - o.start)
    table = {}
    for name in host_ns:
        hits = launched[name]
        table[name] = {
            "host_ms": host_ns[name] / 1e6 / units,
            "dev_ms": sum(ops[i].end - ops[i].start for i in hits
                          if ops[i].cat == "kernel") / 1e6 / units,
            "ops": len(hits) / units,
            "idle_ms": idle.get(name, 0) / 1e6 / units,
        }
    return {
        "units": units,
        "spans": table,
        "outside_idle_ms": idle.get(OUTSIDE, 0) / 1e6 / units,
        "idle_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e6 / units,
        "window_ms": (w1 - w0) / 1e6 / units,
        "ops": len(ops) / units,
        "unlaunched": sum(o.launch is None for o in ops),
        "top": {name: [[k[:80], ns / 1e6 / units] for k, ns in
                       sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]]
                for name, by_kernel in top.items()},
    }


def read(run: dict, kind: str, span: str, key: str):
    """A metric reader's value: ``key`` of ``span`` a unit in the run's span
    table, or None where the run is of another kind or holds no spans."""
    t = run.get("trace") if run.get("kind") == kind else None
    table = t.get("spans") if t else None
    if not table or span not in table["spans"]:
        return None
    return table["spans"][span][key]


def profiled(device, plan, attempts: int = 3):
    """``trace.profiled`` over ``plan`` and, in the same session, one more
    section: the first section's units again, each inside
    ``spans.recording()``. Returns (the reduced sections of ``plan``, the
    span table of the last section, its own reduction)."""
    import sys

    import torch
    from pips_tpu_torch.utils import spans as port_spans
    from torch.profiler import ProfilerActivity

    parts, units, one = plan[0]
    recorded = []

    def spanned(i, part):
        with port_spans.recording() as rec:
            one(i, part)
        if i >= 0:
            recorded.extend(rec)

    full = list(plan) + [(parts, units, spanned)]
    for attempt in range(1, attempts + 1):
        recorded.clear()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace.pad(device)
            for sec_parts, sec_units, fn in full:
                for part in sec_parts:
                    fn(-1, part)
                trace.pad(device)
                for i in range(sec_units):
                    for part in sec_parts:
                        trace.mark()
                        fn(i, part)
                trace.mark()
                trace.pad(device)
        try:
            reduced = trace.sections(trace.from_profiler(prof),
                                     [(p, u) for p, u, _ in full])
        except ValueError as e:
            print(f"portbench: profile attempt {attempt} of {attempts}: {e}", file=sys.stderr)
            continue
        ops = device_ops(prof)
        marks = sorted((o for o in ops if trace.MARK.search(o.name)), key=lambda o: o.start)
        w0, w1 = marks[-(units + 1)].start, marks[-1].end
        own = [o for o in ops if o.end > w0 and o.start < w1]
        return reduced[:len(plan)], join(own, recorded, units), reduced[-1]
    raise ValueError(f"every profile attempt lost a mark ({attempts})")


def lines(table: dict, section: dict, whole: dict) -> list:
    """The span table as text, with the spans section's own idle and device
    time a unit beside the whole units' (recording off) of the same run."""
    n = table["units"]
    out = [f"spans: {n} units, {table['ops']:.1f} device operations a unit, "
           f"{table['unlaunched']} of them without a launch record",
           f"{'span':<16}{'host ms':>11}{'dev ms':>11}{'ops':>10}{'idle ms':>10}"]
    for name, r in sorted(table["spans"].items(), key=lambda kv: -kv[1]["host_ms"]):
        out.append(f"{name:<16}{r['host_ms']:>11.3f}{r['dev_ms']:>11.3f}{r['ops']:>10.1f}"
                   f"{r['idle_ms']:>10.3f}")
    out.append(f"{OUTSIDE:<16}{'':>32}{table['outside_idle_ms']:>10.3f}")
    out.append("kernel ms a unit by the innermost span open at their launch:")
    for name, kernels in table["top"].items():
        out.extend(f"  {name:<16}{ms:>9.3f}  {k}" for k, ms in kernels)
    sec_idle = 1e3 * (section["window_s"] - section["busy_s"]) / n
    out.append(f"idle a unit: {table['idle_ms']:.3f} ms by span, {sec_idle:.3f} ms by the "
               f"section's own union; device clock a unit: {table['window_ms']:.3f} ms spans on, "
               f"{1e3 * whole['window_s'] / whole['units']:.3f} ms spans off (whole units)")
    return out


def run_cell(ctx) -> dict:
    """The cell's record as ``portbench.run`` makes it with ``--trace 1``, with
    the spans section appended to the profile and its table under
    ``record["trace"]["spans"]`` (its own reduction under ``"spans_section"``)."""
    from unittest import mock

    from portbench import spec

    held = {}

    def with_spans(device, plan, attempts=3):
        reduced, held["table"], held["section"] = profiled(device, plan, attempts)
        return reduced

    drive = spec.driver(ctx.work["kind"])
    with mock.patch.object(trace, "profiled", with_spans):
        run = drive.run(ctx)
    run["trace"]["spans"] = held["table"]
    run["trace"]["spans_section"] = held["section"]
    return run


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from portbench import common, spec
    from portbench import run as harness

    ap = argparse.ArgumentParser(description="a cell with the port's spans laid over its trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.cache_dirs(spec.ROOT)
    cell = spec.cell(args.workload, spec.benchmark())
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 1
    harness.card_lines()
    run = run_cell(common.Context(cell, args.seed, args.seconds, True, "cuda", harness.T0))
    t = run["trace"]
    for line in lines(t["spans"], t["spans_section"], t["calls"]):
        print(line, file=sys.stderr)
    metrics = {}
    for path in sorted((spec.HERE / "metrics").glob("*.py")):
        value = spec.reader(path.stem).read(run)
        if value is not None:
            metrics[path.stem] = float(value)
    calls = t["calls"]
    print(json.dumps({
        "workload": cell["name"], "seed": args.seed, "correct": bool(run["correct"]),
        "metrics": metrics, "span_table": t["spans"],
        "whole_ops_a_unit": sum(v["count"] for v in calls["kernels"].values()) / calls["units"],
        "whole_ms_a_unit": 1e3 * calls["window_s"] / calls["units"],
        "section_idle_ms_a_unit": 1e3 * (t["spans_section"]["window_s"]
                                         - t["spans_section"]["busy_s"]) / calls["units"],
        "device": run["device"], "checks": run["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
