"""The port's process mesh (``pips_tpu_torch.parallel``) and what runs on it:
the sharded train step, the point-split trackers and ``run_davis --mesh``,
and the train loop over a mesh.

The mesh arithmetic is held to the JAX package's. What runs across processes
runs here in two processes on the CPU, joined over gloo, each holding the
invariant of a sharded step: at world size 2 it gives the loss, the
gradients and the parameters of the step at world size 1 on the same global
batch, up to the order of summation (the masked means' denominators and the
gradients are summed over the ranks, as JAX's one global computation sums
them). A point-split window, chain and DAVIS run give the unsplit results.
Each process has its own timeout, and the children run one torch thread
each, so that the runs stay light beside the JAX package's multi-process
tests.
"""

import json
import math
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pips_tpu.parallel import default_mesh_shape as jax_default_mesh_shape
from pips_tpu.parallel import batch_pspecs as jax_batch_pspecs
from pips_tpu.parallel.mesh import parse_mesh_arg as jax_parse_mesh_arg
from pips_tpu_torch import parallel
from pips_tpu_torch.parallel import mesh as port_mesh

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 240


@pytest.mark.parametrize("ndev,B,N", [(8, 4, 768), (8, 1, 16), (8, 8, 768), (8, 3, 7),
                                      (1, 4, 768), (2, 1, 128), (4, 2, 6), (6, 4, 9)])
def test_default_mesh_shape_equals_jax(ndev, B, N):
    assert parallel.default_mesh_shape(ndev, B, N) == jax_default_mesh_shape(ndev, B, N)


@pytest.mark.parametrize("grad_acc", [1, 2])
def test_batch_pspecs_equal_jax(grad_acc):
    want = {k: tuple(spec) for k, spec in jax_batch_pspecs(grad_acc).items()}
    assert parallel.batch_pspecs(grad_acc) == want


@pytest.fixture
def group_of_one():
    """A gloo group of this process alone, taken down after the test so that
    no other test of the worker sees a process group."""
    parallel.distributed_init(device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arg", ["", "auto", "1,1", "(1,1)", "[1, 1]", "1,1,1"])
def test_parse_mesh_arg_equals_jax(group_of_one, arg):
    """The same strings give the same meshes: "auto" puts every device (here
    JAX's 8 virtual devices, the port's one process) on the point axis."""
    try:
        want = jax_parse_mesh_arg(arg)
    except AssertionError:
        with pytest.raises(ValueError, match="D,P"):
            parallel.parse_mesh_arg(arg, device="cpu")
        return
    got = parallel.parse_mesh_arg(arg, device="cpu")
    if want is None:
        assert got is None
        return
    assert got.mesh_dim_names == ("data", "point") == want.axis_names
    ndev = want.devices.size
    assert tuple(got.shape) == tuple(d if d < ndev else dist.get_world_size()
                                     for d in want.devices.shape)


def test_one_process_mesh_shards_nothing(group_of_one):
    mesh = parallel.make_mesh((1, 1), device="cpu")
    batch = {k: np.zeros((2, 4, 8, 2)) for k in ("rgbs", "trajs", "visibles", "valids")}
    batch["occs"] = np.zeros(1)
    out = parallel.shard_batch(mesh, batch)
    assert sorted(out) == ["rgbs", "trajs", "valids", "visibles"]
    assert all(v.shape == (2, 4, 8, 2) for v in out.values())
    with pytest.raises(ValueError, match="must hold the 1 processes"):
        parallel.make_mesh((2, 1), device="cpu")


CHILD = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, port, mode, arg = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    from pips_tpu_torch.models.pips import Pips, init_params
    from pips_tpu_torch.parallel import (distributed_init, make_mesh, make_sharded_train_step,
                                         replicate, shard_batch)
    from pips_tpu_torch.train import make_optimizer, make_train_step
    distributed_init(f"localhost:{port}", 2, pid, device="cpu")
    TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
                mixer_depth=2)
    out = {}

    def flat(ts):
        return torch.cat([t.detach().reshape(-1).double() for t in ts])

    if mode == "step":
        shape, grad_acc = arg.split("/")
        grad_acc = int(grad_acc)
        mesh = make_mesh(tuple(int(v) for v in shape.split(",")), device="cpu")

        def fresh():
            m = init_params(Pips(**TINY), 0).train()
            return m, make_optimizer(m.parameters(), 1e-3, 100)

        rng = np.random.RandomState(7)
        B, S, N, H, W = 2 * grad_acc, 4, 16, 64, 96
        b = {"rgbs": (rng.rand(B, S, H, W, 3) * 255).astype(np.float32),
             "trajs": (rng.rand(B, S, N, 2) * [W - 8, H - 8] + 4).astype(np.float32),
             "visibles": (rng.rand(B, S, N) > 0.3).astype(np.float32),
             "valids": (rng.rand(B, S, N) > 0.1).astype(np.float32)}
        if grad_acc > 1:
            b = {k: v.reshape(grad_acc, B // grad_acc, *v.shape[1:]) for k, v in b.items()}
        m, opt = fresh()
        replicate(m)
        step = make_sharded_train_step(m, opt, mesh, iters=2, horz_flip=True, vert_flip=False,
                                       grad_acc=grad_acc)
        met = step(shard_batch(mesh, b, grad_acc))
        m1, opt1 = fresh()
        met1 = make_train_step(m1, opt1, iters=2, horz_flip=True, vert_flip=False,
                               grad_acc=grad_acc)(b)
        g, g1 = flat(p.grad for p in m.parameters()), flat(p.grad for p in m1.parameters())
        p, p1 = flat(m.parameters()), flat(m1.parameters())
        out = dict(metrics=met, metrics1=met1,
                   cos=float(torch.dot(g, g1) / (g.norm() * g1.norm())),
                   gdiff=float((g - g1).abs().max()), gmax=float(g1.abs().max()),
                   pdiff=float((p - p1).abs().max()), lr0=1e-3 / 25, gsum=float(g.sum()))
    elif mode == "files":  # the step from a test's weights and batch, saved for it
        folder, shape, grad_acc = arg.split("|")
        grad_acc = int(grad_acc)
        mesh = make_mesh(tuple(int(v) for v in shape.split(",")), device="cpu")
        m = Pips(**TINY)
        m.load_state_dict(torch.load(f"{folder}/init.pt"))
        m.train()
        b = dict(np.load(f"{folder}/batch.npz"))
        opt = make_optimizer(m.parameters(), 1e-3, 100)

        class Recorded:  # the summed grads, as the optimizer's clip reads them
            def zero_grad(self):
                opt.zero_grad()

            def step(self):
                self.grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
                return opt.step()

        rec = Recorded()
        met = make_sharded_train_step(m, rec, mesh, iters=1, horz_flip=True, vert_flip=False,
                                      grad_acc=grad_acc)(shard_batch(mesh, b, grad_acc))
        if pid == 0:
            torch.save({"grads": rec.grads, "params": m.state_dict()}, f"{folder}/out.pt")
        out = dict(metrics=met)
    elif mode in ("window", "chain"):
        from pips_tpu_torch.inference import ChainTracker, WindowTracker
        mesh = make_mesh((1, 2), device="cpu")
        model = init_params(Pips(**TINY), 0).eval()
        rng = np.random.RandomState(2)
        if mode == "window":
            from pips_tpu_torch.parallel import make_sharded_forward
            rgbs = (rng.rand(1, 4, 48, 64, 3) * 255).astype(np.float32)
            xys = (rng.rand(1, 7, 2) * [56, 40] + 4).astype(np.float32)  # 7: one padded point
            got = WindowTracker(model, iters=2, device="cpu", mesh=mesh)(xys, rgbs)
            want = WindowTracker(model, iters=2, device="cpu")(xys, rgbs)
            fwd = make_sharded_forward(model, mesh, iters=2)(xys, rgbs)
            with torch.no_grad():
                whole = model(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=2,
                              is_train=False, corr_mode="onehot")
            got += tuple(t.numpy() for t in fwd)
            want += (whole.coord_predictions[-1].numpy(), whole.vis_e.numpy(),
                     whole.ffeat.numpy())
        else:
            vid = (rng.rand(10, 48, 64, 3) * 255).astype(np.float32)
            q = (rng.rand(9, 2) * [56, 40] + 4).astype(np.float32)
            got = ChainTracker(model, iters=1, capacity=8, device="cpu",
                               mesh=mesh).track_video(vid, q)
            want = ChainTracker(model, iters=1, capacity=8, device="cpu").track_video(vid, q)
        out = dict(shapes=[list(a.shape) for a in got],
                   diffs=[float(np.abs(a - w).max()) for a, w in zip(got, want)],
                   moved=float(np.ptp(want[0].reshape(-1, *want[0].shape[-2:]), axis=0).max()))
    elif mode == "davis":
        from pips_tpu_torch.evals import common, run_davis
        common.make_pips = lambda S, stride, dtype, device: Pips(S=S, stride=stride, **{
            k: v for k, v in TINY.items() if k not in ("S", "stride")}).to(device).eval()
        kw = dict(init_dir="random", davis_dir=arg, S=8, stride=8, iters=1, chunk=0,
                  resize_hw=(48, 96), max_videos=1, point_stride=16, device="cpu")
        got = run_davis.main(mesh="1,2", **kw)["trajs"]
        want = run_davis.main(mesh="", **kw)["trajs"]
        out = dict(shape=list(got.shape), diff=float(np.abs(got - want).max()))
    elif mode in ("loop", "diverge", "multihost"):
        import dataclasses
        from pips_tpu_torch.train import TrainConfig
        from pips_tpu_torch.train import loop
        saves, seeds = [], []
        real_save, real_batches = loop.saverloader.save, loop.batch_iterator
        loop.saverloader.save = lambda *a, **k: saves.append(a[2]) or real_save(*a, **k)
        loop.batch_iterator = lambda *a, **k: seeds.append(k["seed"]) or real_batches(*a, **k)
        cfg = TrainConfig(**json.loads(arg))
        if mode == "multihost":
            out = dict(metrics=loop.train(cfg, device="cpu"), saves=saves, seeds=seeds)
        elif mode == "diverge":  # process 0 alone writes, so process 1 finds no checkpoint
            cfg = dataclasses.replace(cfg, ckpt_dir=cfg.ckpt_dir + f"_{pid}")
            loop.train(dataclasses.replace(cfg, max_iters=1), device="cpu")
            try:
                loop.train(cfg, device="cpu")
            except RuntimeError as e:
                out = dict(error=str(e), saves=saves)
        else:
            first = loop.train(dataclasses.replace(cfg, max_iters=min(2, cfg.max_iters)),
                               device="cpu")
            more = loop.train(cfg, device="cpu")
            out = dict(first=first, more=more, saves=saves)
    print("RESULT " + json.dumps(out), flush=True)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two(mode: str, arg: str = "-", **env_extra) -> list[dict]:
    """Run CHILD in two processes joined over gloo; their RESULT dicts by rank."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **env_extra}
    env = {k: v for k, v in env.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR",
                                                     "MASTER_PORT", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(i), str(port), mode, arg],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, out in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        assert lines, f"process {i} gave no result:\n{out[-3000:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


@pytest.mark.parametrize("arg", ["2,1/1", "1,2/1", "2,1/2"],
                         ids=["mesh 2x1", "mesh 1x2", "mesh 2x1 grad_acc 2"])
def test_sharded_step_equals_one_process(arg):
    """Loss and metrics within 1e-5 relative, the summed gradients at cosine
    0.9999 and within 1e-5 of their largest entry, the updated parameters
    within one step's first rate (Adam's update on near-zero grads is
    +-lr whatever their rounding), equal on both ranks."""
    ranks = _run_two("step", arg)
    for r in ranks:
        for k, v in r["metrics1"].items():
            assert math.isfinite(v) and abs(r["metrics"][k] - v) <= 1e-5 * max(abs(v), 1), k
        assert r["cos"] >= 0.9999
        assert r["gdiff"] <= 1e-5 * r["gmax"], (r["gdiff"], r["gmax"])
        assert r["pdiff"] <= 2 * r["lr0"], r["pdiff"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"] and ranks[0]["gsum"] == ranks[1]["gsum"]


@pytest.mark.parametrize("mode", ["window", "chain"])
def test_point_split_trackers_equal_one_process(mode):
    """``WindowTracker(mesh=)`` and ``make_sharded_forward`` (7 points, one of
    them padding, 2 iterations; the latter's ffeat too) and
    ``ChainTracker(mesh=)`` (9 points in groups of 8 and 1, 1 iteration)
    at mesh (1, 2) give every rank the unsplit tracker's trajectories and
    visibilities: the points are independent, and only the batch size of a
    product changes, which moves its rounding. Within 1e-5 for the window;
    1e-4 for the chain (measured 7.6e-6), whose later windows start from
    earlier results (at 2 iterations untrained weights amplify 1e-4 px at the
    second window to 2 px by the fourth: the chaos policy of docs/TESTING.md)."""
    ranks = _run_two(mode)
    want = ([[1, 4, 7, 2], [1, 4, 7]] * 2 + [[1, 7, 16]] if mode == "window"
            else [[10, 9, 2], [10, 9]])
    for r in ranks:
        assert r["shapes"] == want
        assert max(r["diffs"]) <= (1e-5 if mode == "window" else 1e-4), r["diffs"]
        assert r["moved"] > 0.5


def test_run_davis_mesh_equals_no_mesh(tmp_path):
    from tests_treeutil import make_davis_tree

    root = make_davis_tree(tmp_path / "davis", n_videos=1)
    ranks = _run_two("davis", root)
    for r in ranks:
        assert r["shape"] == [8, 18, 2]
        assert r["diff"] <= 1e-5, r["diff"]


LOOP = dict(B=2, S=4, N=8, crop_size=[64, 96], I=1, dtype="float32", latent_dim=16,
            corr_levels=3, corr_radius=2, mixer_dim=32, mixer_depth=2, dataset="synthetic", lr=1e-4,
            log_freq=2, val_freq=2, save_freq=1, val_batches=1, num_workers=1,
            metrics_every=1, max_iters=3)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_loop_trains_resumes_and_equals_one_process(tmp_path, shape):
    """Two steps at mesh ``shape``, then a relaunch to step 3 that resumes at
    step 2. Process 0 alone writes checkpoints and returns metrics (as the
    JAX loop's ``is_main``), and they equal the one-process loop's."""
    from pips_tpu_torch.train import TrainConfig
    from pips_tpu_torch.train.loop import train

    cfg = dict(LOOP, mesh_shape=list(shape), ckpt_dir=str(tmp_path / "c"),
               log_dir=str(tmp_path / "l"))
    ranks = _run_two("loop", json.dumps(cfg))
    assert ranks[0]["saves"] == [1, 2, 3] and ranks[1]["saves"] == []
    assert ranks[1]["first"] == ranks[1]["more"] == {}
    one = dict(cfg, mesh_shape=[1, 1], ckpt_dir=str(tmp_path / "c1"), log_dir=str(tmp_path / "l1"))
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_first = train(TrainConfig(**dict(one, max_iters=2)), device="cpu")
        want_more = train(TrainConfig(**one), device="cpu")
    finally:
        torch.set_num_threads(torch_threads)
    for got, want in ((ranks[0]["first"], want_first), (ranks[0]["more"], want_more)):
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1), (k, got[k], v)
    (run,) = os.listdir(tmp_path / "c")
    assert sorted(os.listdir(tmp_path / "c" / run)) == ["model-000000003.pt"]
    (logs,) = os.listdir(tmp_path / "l")
    with open(tmp_path / "l" / logs / "events.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "pooled/total_loss" in r] == [1, 2, 3]  # one writer


def test_sharded_loop_refuses_a_divergent_resume(tmp_path):
    cfg = dict(LOOP, max_iters=2, mesh_shape=[2, 1], ckpt_dir=str(tmp_path / "c"),
               log_dir=str(tmp_path / "l"))
    ranks = _run_two("diverge", json.dumps(cfg))
    for r in ranks:
        assert "auto-resume divergence" in r["error"] and "[0, 1]" in r["error"]
    assert ranks[0]["saves"] == [1] and ranks[1]["saves"] == []


def test_multihost_loop_seeds_each_host(tmp_path):
    """``--multihost`` with each process a host of its own (LOCAL_WORLD_SIZE
    1): the hosts stack on the data axis, each loads its own B with the JAX
    loop's seed 125 + 1000 * host (the probe batch keeps 777), and process 0
    alone writes the checkpoint and returns the metrics."""
    cfg = dict(LOOP, B=1, max_iters=2, val_freq=0, multihost=True, mesh_shape=[1, 1],
               ckpt_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    ranks = _run_two("multihost", json.dumps(cfg), LOCAL_WORLD_SIZE="1")
    assert [r["seeds"][0] for r in ranks] == [125, 1125]
    assert ranks[0]["saves"] == [1, 2] and ranks[1]["saves"] == []
    assert math.isfinite(ranks[0]["metrics"]["total_loss"]) and ranks[1]["metrics"] == {}


@pytest.mark.parametrize("rank,hosts,want", [(0, 1, [0]), (3, 1, [3]), (1, 2, [1]), (3, 2, [1]),
                                             (2, 2, [0])])
def test_shard_batch_takes_this_ranks_rows(monkeypatch, rank, hosts, want):
    """A (4, 1) mesh: each rank's row of B=4 (``hosts`` 1), or of a host's
    B=2 when two hosts hold two rows each (ranks 2 and 3 on the second)."""
    class Mesh:
        shape = (4, 1)
        mesh_dim_names = ("data", "point")

        def get_local_rank(self, axis):
            return rank if axis == "data" else 0

    B = 4 // hosts
    batch = {k: np.arange(B * 2).reshape(B, 1, 2) for k in ("rgbs", "trajs", "visibles",
                                                          "valids")}
    out = parallel.shard_batch(Mesh(), batch, hosts=hosts)
    assert out["trajs"].reshape(-1)[::2].tolist() == [2 * w for w in want]


@pytest.mark.parametrize("rank,want", [(0, [[0, 1], [2, 3]]), (1, [[4, 5], [6, 7]]),
                                       (2, [[8, 9], [8, 9]])])
def test_point_shard_pads_with_the_last_point(monkeypatch, rank, want):
    """Five points over a mesh of three processes: two each, the last
    process's second the repeated last point, as the JAX tracker pads."""
    class Mesh:
        def size(self):
            return 3

    monkeypatch.setattr(port_mesh, "_world", lambda: (rank, 3))
    part, n = port_mesh.point_shard(torch.arange(10.0).reshape(1, 5, 2), Mesh(), dim=1)
    assert n == 5
    np.testing.assert_array_equal(part.numpy(), [want])
