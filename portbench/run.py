"""Run one cell of the benchmark of ``pips_tpu_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the port and the cell's model, makes the
weights and the traffic from the seed, warms up at the cell's shapes, runs
the closed loop for ``--seconds`` seconds, then (with ``--trace 1``)
profiles a few more windows or steps, and holds what the timed window
produced to the plain reference. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` when traced, and last ``checks``: each number compared beside
its limit, which the last lines of standard error repeat. Exits non-zero,
printing no result, without a CUDA card, with a cell that is not in
``BENCHMARK.json``, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import common, spec  # noqa: E402
from portbench.roofline import PEAK_BYTES, PEAK_FLOPS  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pips_tpu")


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its own into ``build/pips_tpu_torch/``), and no Flax."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``pips_tpu_torch`` is not ``pips_tpu``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def assemble(cell: dict, run: dict, traced: bool) -> dict:
    """The result line: each metric's reader over the run's record."""
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(run["device"])
    line = {"correct": bool(run["correct"]), "attempted": int(run["attempted"]),
            "failed": int(run["failed"]), "metrics": metrics, "device": device}
    if traced:
        calls, parts = run["trace"]["calls"], run["trace"]["parts"]
        device["busy_s"] = calls["busy_s"]
        device["window_s"] = calls["window_s"]
        line["breakdown"] = {"device_ops": calls["device_ops"], "idle_gaps": parts["idle_gaps"]}
    line["checks"] = run["checks"]
    return line


def card_lines() -> None:
    """The peaks the shares are taken against, and the card's power limit."""
    print(f"peaks: bf16 {PEAK_FLOPS['bfloat16']:.4g} FLOP/s, f32 {PEAK_FLOPS['float32']:.4g} "
          f"FLOP/s, HBM {PEAK_BYTES:.4g} B/s (H100 SXM at 700 W)", flush=True)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi: {e}"
    print(f"card: {out}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(spec.ROOT)
    try:
        cell = spec.cell(args.workload, spec.benchmark())
        drive = spec.driver(cell["work"]["kind"])
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    card_lines()
    ctx = common.Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    run = drive.run(ctx)
    line = assemble(cell, run, bool(args.trace))
    if args.trace:  # what the profiler costs a whole unit
        calls = run["trace"]["calls"]
        print(f"a unit: {1e3 * run['window_s'] / run['units']:.2f} ms in the timed window "
              f"(host clock), {1e3 * calls['window_s'] / calls['units']:.2f} ms profiled "
              f"(device clock), {1e3 * calls['busy_s'] / calls['units']:.2f} ms of it busy",
              file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in run["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
