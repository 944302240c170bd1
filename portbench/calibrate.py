"""Readings that the limits of a cell's correctness check are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9]

on the card, in one process. For each of ``--seeds`` it builds the program
from the seed as a run does and compares what it produces (the cell's
``checked_windows`` windows, or its ``checked_steps`` training steps) with
the plain reference: the lower readings. For each of ``--control-seeds`` it
puts the reference, computed in float8 (e4m3 operands of every product,
e5m2 gradients), in the program's place: the upper readings. For a training cell each of
``--fault-seeds`` also reads the fault "half of the batch left out, the mean
taken over the rest", planted in the reference put in the program's place.
One JSON line a reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import common, spec
from portbench.run import cache_dirs


def window_readings(drive, ctx, control: bool) -> dict:
    import torch
    from portbench.reference import pips as ref
    from portbench.reference.params import make_params

    p, cfg = ctx.params, ctx.model
    s = common.seeds(ctx.seed)
    frames = [c["rgbs"][None] for c in common.clip_pool(p, cfg["S"], s["traffic"])]
    xys = drive.queries(p)
    k = p["checked_windows"]
    if control:
        params = make_params(cfg, s["weights"], ctx.device)
        q = torch.as_tensor(xys).to(ctx.device)
        outs = []
        with ref.reference_mode():
            for i in range(k):
                rgbs = torch.as_tensor(frames[i % len(frames)]).to(ctx.device)
                t, v = ref.window(params, cfg, rgbs, q, p["iters"], ref.Precision("float8"))
                outs.append((t.cpu().numpy(), v.cpu().numpy()))
        del params
    else:
        tracker = drive.make_tracker(ctx, make_params(cfg, s["weights"], ctx.device))
        outs = [tracker(xys, frames[i % len(frames)]) for i in range(k)]
        del tracker
    common.free(ctx.device)
    return drive.check(ctx, frames, xys, outs, s["sample"])


def train_readings(drive, ctx, kind: str) -> dict:
    import torch
    from pips_tpu_torch.train import make_optimizer, make_train_step
    from portbench.reference import pips as ref
    from portbench.reference.params import make_params

    p, cfg = ctx.params, ctx.model
    s = common.seeds(ctx.seed)
    pool = drive.clips(p, cfg["S"], s["traffic"])[:p["checked_steps"]]
    if kind == "program":
        model = common.build_model(cfg, make_params(cfg, s["weights"], ctx.device), ctx.device,
                                   train=True)
        opt = make_optimizer(model.parameters(), lr=p["lr"], num_steps=p["num_steps"])
        step = make_train_step(model, opt, iters=p["iters"], horz_flip=p["horz_flip"],
                               vert_flip=p["vert_flip"], sync_metrics=False)
        batches = [{k: torch.from_numpy(c[k]).to(ctx.device) for k in drive.KEYS} for c in pool]
        seen = drive.first_steps(step, opt, model, batches)
        del model, opt, step, batches
    elif kind == "control":
        seen = drive.reference_steps(ctx, pool, "float8")
    else:  # the fault: the loss over half the flipped batch
        whole = ref.flip_double

        def half(*args):
            return tuple(t[: t.shape[0] // 2] for t in whole(*args))

        ref.flip_double = half
        try:
            seen = drive.reference_steps(ctx, pool)
        finally:
            ref.flip_double = whole
    common.free(ctx.device)
    refr = drive.reference_steps(ctx, pool)
    losses = [[abs(x - y) / abs(y) for x, y in zip(a, b)]
              for a, b in zip(seen["losses"], refr["losses"])]
    return {**drive.compare(seen, refr), "loss_gaps": [max(c) for c in zip(*losses)],
            "detail": detail(seen, refr)}


def detail(seen: dict, refr: dict, top: int = 4) -> dict:
    """Where a training reading comes from: each step's gaps of the loss and
    of its three terms (seq, vis, ce), and the kept leaves with the widest
    gradient and change gaps (their reference norm beside the median's)."""
    import statistics

    g_ref = refr["grad_norms"]
    g_med = statistics.median(g_ref.values())
    diff = sorted(float((seen["first_grad"][k] - refr["first_grad"][k]).norm()) / g_ref[k]
                  for k in g_ref if g_ref[k] >= 1e-3 * g_med)
    out = {"grad_diff_quartiles": [diff[int(q * (len(diff) - 1))] for q in (0.25, 0.5, 0.75, 1.0)],
           "step_loss_gaps": [[abs(x - y) / abs(y) for x, y in zip(a, b)]
                              for a, b in zip(seen["losses"], refr["losses"])],
           "ref_losses": refr["losses"]}
    g_med = statistics.median(refr["grad_norms"].values())
    kept = {k for k, v in refr["grad_norms"].items() if v >= 1e-3 * g_med}
    for key in ("grad_norms", "change_norms"):
        med = statistics.median(v for k, v in refr[key].items() if k in kept)
        gaps = sorted(((abs(seen[key][k] - v) / max(v, med), k, v) for k, v in refr[key].items()
                       if k in kept), reverse=True)[:top]
        out[key] = {"median": med, "worst": [[k, g, v] for g, k, v in gaps]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cache_dirs(spec.ROOT)
    cell = spec.cell(args.workload, spec.benchmark())
    drive = spec.driver(cell["work"]["kind"])
    window = cell["work"]["kind"] == "window"
    jobs = ([("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
            + [("fault_half_batch", s) for s in args.fault_seeds])
    for kind, seed in jobs:
        if window and kind == "fault_half_batch":
            continue
        ctx = common.Context(cell, seed, 0.0, False, "cuda")
        t = time.perf_counter()
        got = (window_readings(drive, ctx, kind == "control") if window
               else train_readings(drive, ctx, kind))
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
