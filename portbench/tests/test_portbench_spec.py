"""The harness finds each configuration, cell, traffic kind and metric by
name, and refuses what it cannot find."""

from __future__ import annotations

import json

import pytest

from portbench import spec


def test_every_cell_config_and_metric_is_found():
    bench = spec.benchmark()
    names = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        used.add(w["config"])
        assert cell["model"]["name"] == w["config"]
        assert cell["work"]["traffic"] == w["traffic"]
        assert hasattr(spec.driver(cell["work"]["kind"]), "run")
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
        assert set(cell["work"]["limits"]) and all(v > 0 for v in cell["work"]["limits"].values())
    assert used == names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)



def test_config_files_hold_the_published_widths():
    bench = spec.benchmark()
    for c in bench["configs"]:
        model = json.loads((spec.ROOT / c["file"]).read_text())
        assert model["reduced"] == c["reduced"] == []
        assert (model["latent_dim"], model["mixer_dim"], model["mixer_depth"]) == (128, 512, 12)
        assert (model["corr_levels"], model["corr_radius"], model["S"]) == (4, 3, 8)


@pytest.mark.parametrize("call, name", [
    (spec.cell, "pips_s8.no_such_cell"),
    (spec.cell, "../BENCHMARK"),
    (spec.driver, "no_such_kind"),
    (spec.driver, "../run"),
    (spec.reader, "no_such_metric"),
    (spec.reader, "a b"),
])
def test_unknown_names_are_refused(call, name):
    with pytest.raises(spec.SpecError):
        if call is spec.cell:
            call(name, spec.benchmark())
        else:
            call(name)


def test_the_command_refuses_an_unknown_cell(capsys):
    from portbench import run

    assert run.main(["--workload", "pips_s8.no_such_cell", "--seed", "1", "--seconds", "1"]) == 2
    assert "no cell" in capsys.readouterr().err


def test_the_command_refuses_to_run_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from portbench import run

    assert run.main(["--workload", "pips_s8.davis_dense", "--seed", "1", "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
