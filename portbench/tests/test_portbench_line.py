"""The result line, assembled from canned timings and a canned trace."""

from __future__ import annotations

import json

import pytest

from portbench import run as harness
from portbench import spec, trace
from portbench.roofline import chanff_bound, chanff_bwd_bound

SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def canned_events(parts, units, per_part):
    """A mark before each part and after the last; ``per_part[part]`` lists
    (name, cat, microseconds) run back to back 2 us after the part's mark,
    then 3 us of idle before the next mark."""
    ev, t = [trace.Event("pad", "kernel", 0.0, 1.0)], 10.0
    for _ in range(units):
        for part in parts:
            ev.append(trace.Event(SPIN, "kernel", t, t + 1.0))
            t += 3.0
            for name, cat, us in per_part.get(part, []):
                ev.append(trace.Event(name, cat, t, t + us))
                t += us
            t += 3.0
    ev.append(trace.Event(SPIN, "kernel", t, t + 1.0))
    ev.append(trace.Event("pad", "kernel", t + 5.0, t + 6.0))
    return ev


FWD = [("void tc::chanff_fwd_ln<512>(x)", "kernel", 10.0),
       ("void tc::chanff_fwd_act<512>(x)", "kernel", 400.0),
       ("void tc::chanff_fwd_out<512>(x)", "kernel", 300.0)]
BWD = [("void tc::chanff_bwd_ln<512>(x)", "kernel", 10.0),
       ("void tc::chanff_bwd_act<512>(x)", "kernel", 300.0),
       ("void tc::chanff_bwd_dxa<512>(x)", "kernel", 200.0),
       ("void tc::chanff_bwd_wgrad<512>(x)", "kernel", 200.0),
       ("chanff_bwd_colsum(float const*)", "kernel", 20.0)]


UP = [("Memcpy HtoD (Pageable -> Device)", "memcpy", 50.0)]
DOWN = [("Memcpy DtoH (Device -> Pageable)", "memcpy", 5.0)]
CONV = [("conv", "kernel", 100.0)]


def canned_trace(whole, per_part, units=2):
    """The record of both profiled sections: ``units`` whole calls, each
    running ``whole``, then ``units`` split ones."""
    return {"calls": trace.reduce(canned_events(("call",), units, {"call": whole}),
                                  ("call",), units),
            "parts": trace.reduce(canned_events(tuple(per_part), units, per_part),
                                  tuple(per_part), units)}


def serve_run():
    # the split's encode uploads the frames itself, as the whole call does
    t = canned_trace(UP + CONV + FWD * 2 + DOWN, {"encode": UP + CONV, "track": FWD * 2})
    t["chanff_fwd_calls"] = 4
    return {"kind": "window", "correct": True, "attempted": 10, "failed": 0,
            "checks": {"traj_err_p90": {"value": 0.01, "limit": 0.07}},
            "setup_s": 12.5, "window_s": 2.0, "latencies_s": [0.1 * (i + 1) for i in range(10)],
            "units": 10, "point_frames": 10 * 7680 * 8, "chanff_rows": 61440,
            "dtype": "bfloat16", "forward_flops": 2.0e13, "trace": t,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                       "memory_peak_bytes": 3 << 30}}


def test_untraced_line_holds_the_cells_end_to_end_metrics():
    cell = spec.cell("pips_s8.davis_dense", spec.benchmark())
    run = serve_run()
    line = harness.assemble(cell, run, traced=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    m = line["metrics"]
    assert set(m) == {"track_pf_per_s", "window_p90_ms", "setup_s"}
    assert m["track_pf_per_s"] == {"value": 10 * 7680 * 8 / 2.0, "unit": "point-frames/s"}
    assert m["window_p90_ms"]["value"] == pytest.approx(910.0)
    assert m["setup_s"]["value"] == 12.5
    json.loads(json.dumps(line))


def test_traced_line_holds_the_per_layer_metrics_and_a_breakdown():
    cell = spec.cell("pips_s8.davis_dense", spec.benchmark())
    run = serve_run()
    line = harness.assemble(cell, run, traced=True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) == {"copy_ms.serve", "encode_ms.serve", "track_ms.serve",
                      "chanff_fwd_roofline.serve", "mfu.serve", "idle_share.serve"}
    assert m["copy_ms.serve"] == pytest.approx(0.055)
    assert m["encode_ms.serve"] == pytest.approx(0.1)
    assert m["track_ms.serve"] == pytest.approx(1.42)
    # one call's three kernels took 710 us
    assert m["chanff_fwd_roofline.serve"] == pytest.approx(
        100 * chanff_bound(61440, "bfloat16")[0] * 1e3 / 710.0)
    assert m["mfu.serve"] == pytest.approx(100 * 2.0e13 * 10 / 2.0 / 989e12)
    t = run["trace"]["calls"]
    assert line["device"]["busy_s"] == t["busy_s"] and line["device"]["window_s"] == t["window_s"]
    assert 0 < m["idle_share.serve"] < 100
    # the idle share is the whole calls' (5 us of marks and gaps a call), not the split's
    assert m["idle_share.serve"] == pytest.approx(100 * (1 - t["busy_s"] / t["window_s"]))
    assert m["idle_share.serve"] < 100 * (1 - run["trace"]["parts"]["busy_s"]
                                          / run["trace"]["parts"]["window_s"])
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert all(name in ("encode", "track") for name, _ in line["breakdown"]["idle_gaps"])
    for name in ("chanff_fwd_roofline.serve", "mfu.serve", "idle_share.serve"):
        assert 0 < m[name] <= 100


def test_train_line_reads_the_backward_roofline():
    per_part = {"forward": FWD * 3, "backward": BWD * 3, "optimizer": [("adam", "kernel", 9.0)]}
    t = canned_trace([e for part in per_part.values() for e in part], per_part)
    t.update(chanff_fwd_calls=6, chanff_bwd_calls=6)
    run = dict(serve_run(), kind="train_step", trace=t, chanff_rows=24576, units=40,
               window_s=10.0, forward_flops=6.0e12, point_frames=40 * 4 * 768 * 8)
    cell = spec.cell("pips_s8.train_default", spec.benchmark())
    m = {k: v["value"] for k, v in harness.assemble(cell, run, traced=True)["metrics"].items()}
    assert m["chanff_bwd_roofline.train"] == pytest.approx(
        100 * chanff_bwd_bound(24576, "bfloat16")[0] * 1e3 / 730.0)
    assert m["forward_ms.train"] == pytest.approx(3 * 0.71)
    assert m["backward_ms.train"] == pytest.approx(3 * 0.73)
    calls = t["calls"]
    assert m["idle_share.train"] == pytest.approx(100 * (1 - calls["busy_s"] / calls["window_s"]))
    assert m["mfu.train"] == pytest.approx(100 * 3 * 6.0e12 * 40 / 10.0 / 989e12)
    untraced = harness.assemble(cell, run, traced=False)["metrics"]
    assert set(untraced) == {"train_pf_per_s", "setup_s"}


def test_a_roofline_with_no_kernels_to_read_is_left_out():
    run = serve_run()
    calls = run["trace"]["calls"]
    calls["kernels"] = {k: v for k, v in calls["kernels"].items() if "chanff" not in k}
    cell = spec.cell("pips_s8.davis_dense", spec.benchmark())
    assert "chanff_fwd_roofline.serve" not in harness.assemble(cell, run, True)["metrics"]


def test_a_trace_that_lost_a_mark_is_refused():
    ev = [e for i, e in enumerate(canned_events(("a", "b"), 1, {})) if i != 1]
    with pytest.raises(ValueError, match="marks"):
        trace.reduce(ev, ("a", "b"), 1)


def test_one_trace_splits_into_its_sections_by_their_marks():
    whole = canned_events(("call",), 2, {"call": UP + CONV})
    split = [trace.Event(e.name, e.cat, e.start + 1e4, e.end + 1e4)
             for e in canned_events(("encode", "track"), 3, {"encode": CONV, "track": FWD})]
    calls, parts = trace.sections(whole + split, [(("call",), 2), (("encode", "track"), 3)])
    assert calls["units"] == 2 and calls["copy_ms"] == pytest.approx(0.05)
    assert set(calls["kernels"]) == {"Memcpy HtoD (Pageable -> Device)", "conv"}
    assert parts["kernel_ms_by_part"] == pytest.approx({"encode": 0.1, "track": 0.71})
    with pytest.raises(ValueError, match="marks"):
        trace.sections(whole[:1] + whole[2:] + split, [(("call",), 2), (("encode", "track"), 3)])


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "pips_tpu_torchx", types.ModuleType("pips_tpu_torchx"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pips_tpu.models", types.ModuleType("pips_tpu.models"))
    assert harness.forbidden_modules() == ["pips_tpu"]
