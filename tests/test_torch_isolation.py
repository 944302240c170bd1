"""The port stands alone: importing every pips_tpu_torch module and
chip_smoke.py loads nothing of JAX and nothing of the JAX package, nothing
fetches weights from the hub, and its entry points refuse to fall back to
the CPU when CUDA is absent."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

CHILD = r"""
import importlib, json, pkgutil, runpy, sys
import pips_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pips_tpu_torch.__path__, "pips_tpu_torch.")]
for n in names:
    importlib.import_module(n)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imported")  # defines, does not run main()
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "pips_tpu"))
print(json.dumps({"modules": names, "banned": banned}))
"""


def test_port_imports_no_jax_and_nothing_of_pips_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", CHILD, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pips_tpu_torch.kernels.mixer_cuda" in res["modules"]
    assert "pips_tpu_torch.convert" in res["modules"]
    for name in ("kernels.block_cuda", "kernels.stem_wgrad_cuda", "tools.profile_block_kernel",
                 "tools.profile_stem_wgrad", "kernels.chanff_chunk_cuda",
                 "tools.profile_chanff_chunk", "kernels.mixer_probes_cuda",
                 "kernels.corr_rows_cuda", "kernels.row_contract_cuda",
                 "tools.debug_mixer_kernel", "tools.debug_pallas7", "tools.probe_mosaic_ops",
                 "data.flyingthings", "data.pointodyssey", "data.badja", "data.crohd",
                 "data.augs", "data.pfm", "native.lib", "ops.fps", "utils.cli", "datagen.run",
                 "datagen.trajs", "datagen.occluders", "evals", "evals.common", "evals.metrics",
                 "evals.run_flt", "evals.run_badja", "evals.run_crohd", "evals.run_davis",
                 "torchport", "torchport.convert", "utils.format", "utils.improc", "ops.embed",
                 "models.raft", "models.dino", "inference.flow_chain", "parallel",
                 "parallel.mesh", "utils.flax_msgpack", "demo", "chain_demo", "version"):
        assert f"pips_tpu_torch.{name}" in res["modules"]
    assert res["banned"] == []


@pytest.mark.parametrize("module", ["pips_tpu_torch", "pips_tpu_torch.inference.window",
                                    "pips_tpu_torch.inference.chain", "pips_tpu_torch.parallel"])
def test_serving_layer_imports_no_trainer(module):
    """The trackers and the mesh load nothing of ``train``: the sharded step
    imports the train step when it is built, as the JAX package's does."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    code = (f"import json, sys; import {module}; "
            f"print(json.dumps(sorted(m for m in sys.modules if m.startswith('pips_tpu_torch.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pips_tpu_torch.parallel.mesh" in loaded
    assert [m for m in loaded if m.startswith("pips_tpu_torch.train")] == []


def test_port_never_reaches_torch_hub():
    """The port takes baseline weights only from local files: no source of
    the package, and not chip_smoke.py, names the hub."""
    sources = [*sorted((REPO / "pips_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    assert len(sources) > 50
    for path in sources:
        text = path.read_text()
        assert "torch.hub" not in text and "hub.load" not in text, path


def test_host_library_is_the_ports_own():
    """The port builds its host library from its own source and never names
    the JAX package's prebuilt ``native/libpipshost.so``."""
    lib = (REPO / "pips_tpu_torch" / "native" / "lib.py").read_text()
    assert "libpipshost.so" not in lib and "NATIVE_DIR" not in lib
    assert (REPO / "pips_tpu_torch" / "native" / "pips_host.cpp").is_file()
    from pips_tpu_torch.native import lib as native_lib

    assert native_lib.SOURCE == REPO / "pips_tpu_torch" / "native" / "pips_host.cpp"
    assert native_lib.library_path().parent == REPO / "build" / "pips_tpu_torch"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from pips_tpu_torch import Pips, WindowTracker, make_pips
    from pips_tpu_torch.train import TrainConfig
    from pips_tpu_torch.train.loop import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = dict(latent_dim=16, mixer_dim=32, mixer_depth=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_pips(**tiny)
    cfg = TrainConfig(dataset="synthetic", max_iters=1, ckpt_dir=str(tmp_path / "c"),
                      log_dir=str(tmp_path / "l"), **tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg)  # the default device; nothing runs on the CPU
    assert not (tmp_path / "c").exists() and not (tmp_path / "l").exists()
    model = make_pips(device="cpu", **tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WindowTracker(model)
    assert WindowTracker(model, device="cpu").device.type == "cpu"
    assert isinstance(model, Pips)
    from pips_tpu_torch import chain_demo, demo
    from pips_tpu_torch.parallel import distributed_init

    missing = str(tmp_path / "no_such_jpgs")
    for main in (demo.main, chain_demo.main):  # before any frame or weight is read
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(init_dir=str(tmp_path / "no_such_ckpt"), images_dir=missing)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed_init()
    assert not torch.distributed.is_initialized()


EVAL_RUNNERS = {"run_flt": "dataset_location", "run_badja": "data_dir",
                "run_crohd": "dataset_root", "run_davis": "davis_dir"}


@pytest.mark.parametrize("runner", sorted(EVAL_RUNNERS))
def test_eval_runners_need_cuda_before_reading_data(monkeypatch, tmp_path, runner):
    """Without a card each runner's ``main`` (the CUDA default) and the eval
    model factory raise before any data or weights are read."""
    import importlib

    from pips_tpu_torch.evals import common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read = []
    mod = importlib.import_module(f"pips_tpu_torch.evals.{runner}")
    for holder in (common, mod):  # run_badja and run_davis bind the name at import
        if hasattr(holder, "load_params"):
            monkeypatch.setattr(holder, "load_params", lambda *a, **k: read.append(a))
    missing = str(tmp_path / "no_such_set")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(init_dir=str(tmp_path / "no_such_ckpt"), **{EVAL_RUNNERS[runner]: missing})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.make_pips(S=8, stride=4, dtype="bfloat16")
    assert read == [] and not (tmp_path / "no_such_set").exists()


@pytest.mark.parametrize("modeltype", ["raft", "dino"])
def test_baselines_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path, modeltype):
    """The baseline builder and its trackers raise without a card before
    reading weights; on the CPU a missing weights file raises, nothing is
    fetched."""
    from pips_tpu_torch.evals import common
    from pips_tpu_torch.inference import FlowChainTracker
    from pips_tpu_torch.models.dino import DinoTracker
    from pips_tpu_torch.models.raft import RAFT, Raftnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / f"{modeltype}.pth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.build_baseline_tracker(modeltype, missing)
    with pytest.raises(FileNotFoundError):
        common.build_baseline_tracker(modeltype, missing, device="cpu")
    for make in (lambda: Raftnet(RAFT()), lambda: FlowChainTracker(lambda a, b: a),
                 lambda: DinoTracker(lambda x: x)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not (tmp_path / f"{modeltype}.pth").exists()


def test_chip_smoke_fails_without_cuda():
    """Here there is no card: the smoke must exit non-zero and print no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
