"""Whole runs of each cell on the CPU at TINY widths, past the harness's look
for a card: a sound run is correct; the control (the reference in float8,
put in the program's place) and each fault the cell can have, planted under
the timed path, come out not correct. One cell card run is marked ``chip``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import common, spec
from portbench.reference import pips as ref
from portbench.reference.params import make_params

ROOT = Path(spec.ROOT)
SERVE = ("pips_s8.davis_dense", "pips_s4.hd_grid")
TRAIN = "pips_s8.train_default"


class ReferenceTracker:
    """The plain reference in the program's place, in ``precision``."""

    def __init__(self, ctx, precision):
        self.ctx, self.prec = ctx, ref.Precision(precision)
        self.p = make_params(ctx.model, common.seeds(ctx.seed)["weights"], "cpu")

    def __call__(self, xys, rgbs):
        t, v = ref.window(self.p, self.ctx.model, torch.as_tensor(rgbs), torch.as_tensor(xys),
                          self.ctx.params["iters"], self.prec)
        return t.numpy(), v.numpy()


def run_window(ctx, wrap=None, replace=None):
    drive = spec.driver("window")
    make = drive.make_tracker
    if replace is not None:
        drive.make_tracker = lambda c, params: replace(c)
    elif wrap is not None:
        drive.make_tracker = lambda c, params: wrap(make(c, params))
    return drive.run(ctx)


def over_limit(run):
    return [k for k, c in run["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", SERVE)
def test_a_sound_window_run_is_correct(name, tiny_cell, ctx_of):
    run = run_window(ctx_of(tiny_cell(name)))
    assert run["correct"] and run["failed"] == 0 and run["attempted"] >= 2, run["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_the_float8_control_is_not_correct(name, tiny_cell, ctx_of):
    run = run_window(ctx_of(tiny_cell(name)), replace=lambda c: ReferenceTracker(c, "float8"))
    assert not run["correct"] and over_limit(run)


def shifted(tracker):
    """An answer altered where it is produced: every tracked point one pixel off."""
    def call(xys, rgbs):
        t, v = tracker(xys, rgbs)
        t = t.copy()
        t[:, 1:] += 1.0
        return t, v
    return call


def half_the_points(tracker):
    """Half of the batch left out: the second half of the points never
    tracked, their answers the first half's."""
    def call(xys, rgbs):
        n = xys.shape[1]
        t, v = tracker(xys[:, : n // 2], rgbs)
        rep = -(-n // t.shape[2])
        return np.tile(t, (1, 1, rep, 1))[:, :, :n], np.tile(v, (1, 1, rep))[:, :, :n]
    return call


@pytest.mark.parametrize("fault", [shifted, half_the_points])
@pytest.mark.parametrize("name", SERVE)
def test_a_faulty_window_run_is_not_correct(name, fault, tiny_cell, ctx_of):
    run = run_window(ctx_of(tiny_cell(name)), wrap=fault)
    assert not run["correct"] and over_limit(run)


def test_a_sound_training_run_is_correct(tiny_cell, ctx_of):
    run = spec.driver("train_step").run(ctx_of(tiny_cell(TRAIN)))
    assert run["correct"] and run["attempted"] > 3, run["checks"]
    assert run["point_frames"] == run["units"] * run["chanff_rows"]


def test_the_float8_training_control_is_not_correct(tiny_cell, ctx_of):
    from portbench import calibrate

    ctx = ctx_of(tiny_cell(TRAIN))
    got = calibrate.train_readings(spec.driver("train_step"), ctx, "control")
    limits = ctx.work["limits"]
    checks = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    assert not common.judged(checks, 0)


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(tiny_cell, ctx_of, monkeypatch):
    from pips_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step",
                        lambda self: optim.clip_by_global_norm_(self.params, self.clip))
    run = spec.driver("train_step").run(ctx_of(tiny_cell(TRAIN)))
    assert not run["correct"] and "change_norm_gap" in over_limit(run)
    assert "grad_norm_gap" in over_limit(run)


def test_a_step_over_half_the_batch_is_not_correct(tiny_cell, ctx_of, monkeypatch):
    from pips_tpu_torch.train import step as train_step

    whole = train_step.apply_flip_doubling

    def half(batch, horz, vert):
        out = whole(batch, horz, vert)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(train_step, "apply_flip_doubling", half)
    run = spec.driver("train_step").run(ctx_of(tiny_cell(TRAIN)))
    assert not run["correct"] and over_limit(run)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Whole runs in a fresh process, then the forbidden top-level names."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import TINY_MODEL, TINY_TRAFFIC\n"
        "from portbench import common, spec, run\n"
        "for name in %r:\n"
        "    cell = spec.cell(name, spec.benchmark())\n"
        "    cell['model'].update(TINY_MODEL)\n"
        "    p = cell['work']['params']\n"
        "    p.update({k: v for k, v in TINY_TRAFFIC.items() if k in p})\n"
        "    ctx = common.Context(cell, 7, 0.5, False, 'cpu')\n"
        "    r = spec.driver(cell['work']['kind']).run(ctx)\n"
        "    run.assemble(cell, r, False)\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
    ) % (str(Path(__file__).parent), [SERVE[0], TRAIN])
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_harness_module_names_jax_or_the_jax_package():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "pips_tpu"), path


@pytest.mark.chip
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", SERVE[0],
                          "--seed", "5", "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
