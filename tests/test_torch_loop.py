"""The port's train loop (``pips_tpu_torch.train.loop``) and the modules it
runs: config, checkpoints, pools, loader and prefetcher.

The loop runs on the CPU at TINY size, as ``tests/test_loop.py`` runs the JAX
loop: it trains, validates, writes keep-latest checkpoints and resumes from
them with the optimizer's full state. The parity checks against the JAX
package compare host-side code on the same inputs (config parsing and
defaults, run names, pools, the batcher's sample order) and compile nothing.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from pips_tpu_torch.data import DevicePrefetcher, SyntheticPointDataset, batch_iterator
from pips_tpu_torch.train import TrainConfig, parse_cli
from pips_tpu_torch.train.config import resolve_dtype, resolve_fuse_chanff
from pips_tpu_torch.train.loop import init_state, restore, train
from pips_tpu_torch.utils import SimplePool, saverloader

TINY = dict(B=1, S=4, N=8, crop_size=(64, 96), I=1, latent_dim=16, corr_levels=3,
            corr_radius=2, mixer_dim=32, mixer_depth=2, dataset="synthetic",
            horz_flip=False, vert_flip=False, lr=1e-4, log_freq=100, val_freq=2,
            save_freq=2, mesh_shape=(1, 1), use_scheduler=False, val_batches=2,
            num_workers=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_train.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The TINY loop of ``tests/test_loop.py``, 2 steps, run once per module."""
    root = tmp_path_factory.mktemp("loop")
    cfg = TrainConfig(**TINY, max_iters=2, ckpt_dir=str(root / "ckpts"),
                      log_dir=str(root / "logs"))
    return cfg, train(cfg, device="cpu")


def _events(cfg):
    logs = os.listdir(cfg.log_dir)
    assert len(logs) == 1
    with open(os.path.join(cfg.log_dir, logs[0], "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_loop_end_to_end(tiny_run):
    cfg, metrics = tiny_run
    assert np.isfinite(metrics["total_loss"])
    run_dirs = os.listdir(cfg.ckpt_dir)
    assert run_dirs == [cfg.model_name()]
    assert saverloader.list_steps(os.path.join(cfg.ckpt_dir, run_dirs[0])) == [2]
    keys = {k for e in _events(cfg) for k in e}
    assert any(k.startswith("val_pooled/") for k in keys), sorted(keys)
    assert any(k.startswith("pooled/") for k in keys), sorted(keys)


def test_auto_resume_restores_the_full_state(tiny_run, capsys):
    cfg, _ = tiny_run
    ckpt_dir = os.path.join(cfg.ckpt_dir, cfg.model_name())
    saved = torch.load(os.path.join(ckpt_dir, "model-000000002.pt"), weights_only=True)

    model, opt = init_state(cfg, device="cpu")
    assert restore(cfg, model, opt, ckpt_dir) == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    got, want = opt.state_dict()["adamw"], saved["optimizer"]["adamw"]
    assert got["param_groups"] == want["param_groups"]
    assert sorted(got["state"]) == sorted(want["state"]) and len(got["state"]) > 0
    for i, st in want["state"].items():
        for name, t in st.items():
            assert torch.equal(got["state"][i][name], t), (i, name)
    assert float(want["state"][0]["step"]) == 2.0  # two AdamW steps were taken

    capsys.readouterr()
    metrics = train(dataclasses.replace(cfg, max_iters=4), device="cpu")
    out = capsys.readouterr().out
    assert f"auto-resumed from {ckpt_dir} at step 2" in out
    assert "step 000004/4" in out
    assert np.isfinite(metrics["total_loss"])
    assert saverloader.list_steps(ckpt_dir) == [4]
    resumed = torch.load(os.path.join(ckpt_dir, "model-000000004.pt"), weights_only=True)
    assert float(resumed["optimizer"]["adamw"]["state"][0]["step"]) == 4.0


def test_quick_mode_lowers_the_loss(tmp_path, capsys):
    """``--quick`` (B=1, N=16, 20 steps at 128x192, synthetic, val, media and
    saves every 10) at TINY mixer dims, f32, I=2 and no flips (to keep the
    test near 40 s on one CPU thread); every step's loss printed. The mean of
    the last five steps must be below that of the first five (measured 27.4
    against 35.0)."""
    dims = {k: TINY[k] for k in ("latent_dim", "corr_levels", "corr_radius", "mixer_dim",
                                 "mixer_depth", "num_workers")}
    cfg = TrainConfig(quick=True, dtype="float32", metrics_every=1, val_batches=1, I=2,
                      horz_flip=False, vert_flip=False, ckpt_dir=str(tmp_path / "ckpts"),
                      log_dir=str(tmp_path / "logs"), **dims)
    train(cfg, device="cpu")
    losses = [float(x) for x in re.findall(r"loss = ([0-9.eE+-]+)", capsys.readouterr().out)]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    (run,) = os.listdir(cfg.ckpt_dir)
    assert saverloader.list_steps(os.path.join(cfg.ckpt_dir, run)) == [20]
    media = os.listdir(os.path.join(cfg.log_dir, os.listdir(cfg.log_dir)[0], "media"))
    assert any("trajs_on_rgbs" in m for m in media) and any("fcp_point0" in m for m in media)


def test_f32_fused_chanff_cli_trains(tmp_path, monkeypatch):
    """``--dtype float32 --fuse_chanff 1``, the command that trains with the
    f32 backward kernel on the card, builds a fused f32 model and takes two
    loop steps at TINY size. On CPU tensors each channel block's backward is
    the plain f32 backward: once per block and iteration of each step."""
    from pips_tpu_torch.kernels import mixer_cuda

    cfg = parse_cli(["--dtype", "float32", "--fuse_chanff", "1"])
    cfg = dataclasses.replace(cfg, **TINY, max_iters=2, ckpt_dir=str(tmp_path / "c"),
                              log_dir=str(tmp_path / "l"))
    model, _ = init_state(cfg, device="cpu")
    mix = model.delta_block.to_delta
    assert mix.fuse_chanff and mix.dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    dtypes = []
    real = mixer_cuda.chan_ff_bwd

    def spy(x, *a):
        dtypes.append(x.dtype)
        return real(x, *a)

    monkeypatch.setattr(mixer_cuda, "chan_ff_bwd", spy)
    metrics = train(cfg, device="cpu")
    assert np.isfinite(metrics["total_loss"])
    assert dtypes == [torch.float32] * (2 * cfg.I * cfg.mixer_depth)


def test_build_dataset_builds_the_jax_sets(tmp_path):
    """``build_dataset`` reads the JAX loop's splits with its arguments:
    FlyingThings++ TRAIN (the configured subset) and TEST (all subsets),
    PointOdyssey train and val."""
    from pips_tpu.train.loop import build_dataset as jax_build_dataset
    from tests_treeutil import make_flyingthings_tree
    from test_torch_data import _make_po_tree

    from pips_tpu_torch.data import FlyingThingsDataset, PointOdysseyDataset
    from pips_tpu_torch.train.loop import build_dataset

    make_flyingthings_tree(tmp_path / "flt", n_traj=40)
    make_flyingthings_tree(tmp_path / "flt", dset="TEST", n_traj=40)
    _make_po_tree(tmp_path / "po", T=10, H=32, W=48, N=20)
    for dataset, cls, loc in [("flyingthings", FlyingThingsDataset, "flt"),
                              ("pointodyssey", PointOdysseyDataset, "po")]:
        cfg = TrainConfig(**{**TINY, "dataset": dataset, "S": 8, "subset": "A",
                             "dataset_location": str(tmp_path / loc)})
        for split in ("train", "val"):
            got, want = build_dataset(cfg, split), jax_build_dataset(cfg, split)
            assert isinstance(got, cls) and len(got) == len(want) > 0
            assert {k: v for k, v in vars(got).items()} == {k: v for k, v in vars(want).items()}
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset(dataclasses.replace(cfg, dataset="kubric"))


def _loop_losses(capsys) -> list:
    return [float(x) for x in re.findall(r"loss = ([0-9.eE+-]+)", capsys.readouterr().out)]


def test_flyingthings_cli_trains(tmp_path, capsys):
    """The loop's default set, ``--dataset flyingthings``, on the small
    FlyingThings++ tree of ``tests/tests_treeutil.py`` (TRAIN and TEST
    splits, 120x160 frames), augs on, at TINY size: three steps with a
    validation pass and a checkpoint, every loss finite."""
    from tests_treeutil import make_flyingthings_tree

    root = tmp_path / "flt"
    make_flyingthings_tree(root)
    make_flyingthings_tree(root, dset="TEST", seed=1)
    cfg = parse_cli(["--dataset_location", str(root)])
    assert cfg.dataset == "flyingthings" and cfg.use_augs
    cfg = dataclasses.replace(cfg, **{**TINY, "dataset": "flyingthings", "S": 8, "val_freq": 3,
                                       "save_freq": 3, "val_batches": 1},
                              dtype="float32", max_iters=3, metrics_every=1, log_media=False,
                              ckpt_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    capsys.readouterr()
    metrics = train(cfg, device="cpu")
    losses = _loop_losses(capsys)
    assert len(losses) == 3 and all(np.isfinite(losses + list(metrics.values())))
    assert saverloader.list_steps(os.path.join(cfg.ckpt_dir, cfg.model_name())) == [3]
    assert any(k.startswith("val_pooled/") for e in _events(cfg) for k in e)


def test_pips2_pointodyssey_cli_trains(tmp_path, capsys):
    """The README's PIPs++ command, ``--model_family pips2 --dataset
    pointodyssey --S 24``, at TINY size on a PointOdyssey tree of 26 frames
    (train and val): two steps, a validation pass and a checkpoint, every
    loss finite, no CE term."""
    from test_torch_data import _make_po_tree

    from pips_tpu_torch import Pips2

    root = _make_po_tree(tmp_path / "po", T=26, H=96, W=128, N=120)
    cfg = parse_cli(["--model_family", "pips2", "--dataset", "pointodyssey", "--S", "24",
                     "--dataset_location", root])
    cfg = dataclasses.replace(cfg, **{**TINY, "dataset": "pointodyssey", "S": 24, "val_freq": 2,
                                       "save_freq": 2, "val_batches": 1},
                              dtype="float32", max_iters=2, metrics_every=1, log_media=False,
                              ckpt_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    assert isinstance(init_state(cfg, device="cpu")[0], Pips2)
    capsys.readouterr()
    metrics = train(cfg, device="cpu")
    losses = _loop_losses(capsys)
    assert len(losses) == 2 and all(np.isfinite(losses + list(metrics.values())))
    assert metrics["ce"] == 0.0
    assert saverloader.list_steps(os.path.join(cfg.ckpt_dir, cfg.model_name())) == [2]


def test_pips2_cli_trains(tmp_path, capsys):
    """``--model_family pips2 --S 6``: the loop builds a ``Pips2`` whose refiner
    is ``mixer_dim`` wide and ``mixer_depth`` deep, as JAX's loop does, and
    trains it at TINY size on the synthetic set (f32, I=1, lr 5e-4, no
    flips), with a validation pass and a checkpoint. PIPs++ has no CE term:
    ``ce`` stays 0. Every loss is finite, and the mean of the last four of
    twelve steps is below that of the first four (measured 22.6 against
    33.7)."""
    from pips_tpu_torch import Pips2

    cfg = parse_cli(["--model_family", "pips2", "--dataset", "synthetic", "--S", "6"])
    cfg = dataclasses.replace(cfg, **{**TINY, "S": 6, "lr": 5e-4, "val_freq": 12,
                                       "save_freq": 12, "val_batches": 1},
                              dtype="float32", max_iters=12, metrics_every=1,
                              ckpt_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    model, _ = init_state(cfg, device="cpu")
    assert isinstance(model, Pips2)
    assert model.refiner.depth == 2 and model.refiner.embed.kernel.shape[1] == 32
    capsys.readouterr()
    metrics = train(cfg, device="cpu")
    losses = [float(x) for x in re.findall(r"loss = ([0-9.eE+-]+)", capsys.readouterr().out)]
    assert len(losses) == 12 and all(np.isfinite(losses)) and metrics["ce"] == 0.0
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert saverloader.list_steps(os.path.join(cfg.ckpt_dir, cfg.model_name())) == [12]


def test_kernel_flags_resolve_like_jax():
    assert resolve_dtype("bf16") is torch.bfloat16 and resolve_dtype("float32") is None
    with pytest.raises(ValueError):
        resolve_dtype("float16")
    assert resolve_fuse_chanff(-1, torch.bfloat16, "cuda")
    assert not resolve_fuse_chanff(-1, None, "cuda")
    assert not resolve_fuse_chanff(-1, torch.bfloat16, "cpu")
    assert resolve_fuse_chanff(1, None, "cpu") and not resolve_fuse_chanff(0, torch.bfloat16,
                                                                            "cuda")
    assert TrainConfig().fuse_conv3 == 0 and TrainConfig().fuse_chanff == -1


def test_config_fields_and_defaults_equal_jax():
    from pips_tpu.train.config import TrainConfig as JaxConfig

    want = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    assert got == want


ARGVS = [
    ["--B", "2", "--lr", "1e-3", "--horz_flip", "false", "--crop_size", "256,384",
     "--dataset=synthetic", "--quick"],
    ["--fuse_conv3", "1", "--fuse-chanff=0", "--dtype", "float32", "--mesh_shape", "(1,1)",
     "--ignore_load", "fnet", "--remat_encoder", "--max_iters=12", "--val_batches", "2"],
    ["--exp_name", "tb89", "--I", "6", "--N", "128", "--vert_flip", "no", "--grad_acc", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["reference", "kernels", "name"])
def test_parse_cli_and_model_name_equal_jax(argv):
    from pips_tpu.train.config import parse_cli as jax_parse_cli

    got, want = parse_cli(argv), jax_parse_cli(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model_name() == want.model_name()
    with pytest.raises(SystemExit):
        parse_cli(["--no_such_field", "1"])


def test_simple_pool_equals_jax():
    from pips_tpu.utils.pools import SimplePool as JaxPool

    vals = np.random.RandomState(0).randn(250) * 10
    a, b = SimplePool(100), JaxPool(100)
    for chunk in np.array_split(vals, 17):
        a.update(chunk)
        b.update(chunk)
        assert a.mean() == b.mean() and len(a) == len(b) and a.is_full() == b.is_full()
    assert np.array_equal(a.fetch(), b.fetch())
    assert np.isnan(SimplePool(3).mean())


@pytest.mark.parametrize("shuffle,grad_acc", [(True, 1), (False, 2)])
def test_batch_iterator_equals_jax(shuffle, grad_acc):
    from pips_tpu.data.loader import batch_iterator as jax_batch_iterator

    ds = SyntheticPointDataset(S=4, N=8, H=32, W=48, seed=3)
    a = batch_iterator(ds, 2, shuffle=shuffle, seed=11, num_workers=3, grad_acc=grad_acc)
    b = jax_batch_iterator(ds, 2, shuffle=shuffle, seed=11, num_workers=3, grad_acc=grad_acc)
    try:
        for _ in range(3):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].shape[:2] == ((grad_acc, 2) if grad_acc > 1 else (2, 4))
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    finally:
        a.close()
        b.close()


def test_keep_latest_checkpoints(tmp_path):
    d = str(tmp_path / "run")
    for step in range(1, 5):
        saverloader.save(d, {"model": {"w": torch.full((2,), float(step))}}, step, keep_latest=2)
    assert saverloader.list_steps(d) == [3, 4]
    assert sorted(os.listdir(d)) == ["model-000000003.pt", "model-000000004.pt"]  # no .tmp
    state, step = saverloader.load(d, {"model": {"w": torch.zeros(2)}})
    assert step == 4 and torch.equal(state["model"]["w"], torch.full((2,), 4.0))
    state, step = saverloader.load(d, {"model": {"w": torch.zeros(2)}}, step=3)
    assert step == 3 and torch.equal(state["model"]["w"], torch.full((2,), 3.0))
    for step in (5, 6):
        saverloader.save(d, {"model": {"w": torch.zeros(2)}}, step, keep_latest=0)
    assert saverloader.list_steps(d) == [3, 4, 5, 6]
    target = {"model": {"fnet.w": torch.ones(2), "head.w": torch.ones(2)}}
    saverloader.save(d, {"model": {"fnet.w": torch.zeros(2), "head.w": torch.zeros(2)}}, 7)
    state, _ = saverloader.load(d, target, ignore_load="fnet")
    assert torch.equal(state["model"]["fnet.w"], torch.ones(2))
    assert torch.equal(state["model"]["head.w"], torch.zeros(2))
    empty, step = saverloader.load(str(tmp_path / "none"), target)
    assert step == 0 and empty["model"] is target["model"]


def test_device_prefetcher_on_cpu_in_order_and_closes():
    batches = [{"rgbs": np.full((1, 2), i, np.float32), "trajs": np.full((1, 3), -i, np.float64)}
               for i in range(6)]
    closed = []

    def source():
        try:
            yield from batches
            while True:
                yield batches[-1]
        finally:
            closed.append(True)

    pf = DevicePrefetcher(source(), device="cpu", depth=2)
    for i in range(6):
        b = next(pf)
        assert b["rgbs"].device.type == "cpu" and b["trajs"].dtype == torch.float32
        assert torch.equal(b["rgbs"], torch.full((1, 2), float(i)))
        assert torch.equal(b["trajs"], torch.full((1, 3), float(-i)))
    pf.close()
    assert not pf.thread.is_alive() and closed == [True]
