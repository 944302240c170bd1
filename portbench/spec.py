"""Find a cell, its configuration, its traffic and its metrics by name.

Everything that belongs to one configuration, one cell or one metric sits in
a file of its own under ``portbench/``, named as ``BENCHMARK.json`` names it:

* ``configs/<config>.json``: the model's sizes (``BENCHMARK.json``'s ``file``);
* ``workloads/<cell>.json``: the cell's traffic kind, its parameters and the
  limits of its correctness check;
* ``traffic/<kind>.py``: the driver of that kind of traffic (``run(ctx)``);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A later change adds a configuration, a cell or a metric by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """An unknown or malformed cell, configuration, traffic kind or metric."""


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"no file {path.relative_to(ROOT)}") from None


def _module(path: Path, label: str):
    if not path.is_file():
        raise SpecError(f"no {label} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "portbench._loaded." + re.sub(r"\W", "_", str(path.relative_to(HERE))), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    """The cell ``name`` as ``BENCHMARK.json`` lists it, merged with its
    workload file, its configuration and the metrics it reports."""
    if not NAME.match(name):
        raise SpecError(f"not a cell name: {name!r}")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    work = _json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise SpecError(f"cell {name}: {key} {work[key]!r} in its workload file, "
                            f"{entry[key]!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise SpecError(f"cell {name}: no configuration {entry['config']!r}")
    model = _json(ROOT / conf["file"])

    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {"name": name, "chips": entry["chips"], "work": work, "model": model,
            "end_to_end": e2e, "per_layer": layer}


def driver(kind: str):
    if not NAME.match(kind):
        raise SpecError(f"not a traffic kind: {kind!r}")
    return _module(HERE / "traffic" / f"{kind}.py", "traffic")


def reader(metric: str):
    if not NAME.match(metric):
        raise SpecError(f"not a metric name: {metric!r}")
    return _module(HERE / "metrics" / f"{metric}.py", "metric")
