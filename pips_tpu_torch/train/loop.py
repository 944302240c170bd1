"""The train loop (counterpart of ``pips_tpu/train/loop.py``).

    python -m pips_tpu_torch.train.loop --dataset_location /data/flyingthings
    python -m pips_tpu_torch.train.loop --model_family pips2 --dataset pointodyssey \
        --dataset_location /data/pointodyssey --S 24

Composes: dataset -> host batcher -> CUDA prefetch -> train step -> pooled
metric logging -> periodic validation, media and checkpointing with
auto-resume. Runs on CUDA unless the caller passes ``device="cpu"``.

``model_family="pips2"`` trains the S-agnostic PIPs++ family (``Pips2``), its
refiner ``mixer_dim`` wide and ``mixer_depth`` deep, as the JAX loop builds it.
``dataset`` is ``flyingthings`` (FlyingThings++, the default), ``pointodyssey``
or ``synthetic``; validation reads FlyingThings++'s TEST split and
PointOdyssey's ``val``. Several processes, one a device, train one model
over a (data, point) mesh (``--mesh_shape``, ``--num_processes``,
``--coordinator``, ``--process_id``, ``--multihost``, or ``torchrun``; see
``join_mesh`` and ``parallel``):

    torchrun --nproc_per_node 2 -m pips_tpu_torch.train.loop --mesh_shape 2,1 ...

``--init_dir`` also warm-starts from the JAX package's ``model-*.msgpack``
checkpoints (``warm_start_from_jax``). The JAX loop's compile cache has no
counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params, state_dict_from_flax
from pips_tpu_torch.data import (DevicePrefetcher, FlyingThingsDataset, PointOdysseyDataset,
                                  SyntheticPointDataset, batch_iterator)
from pips_tpu_torch.models.pips import Pips, init_params, resolve_device
from pips_tpu_torch.models.pips2 import Pips2
from pips_tpu_torch.parallel.mesh import (default_mesh_shape, distributed_init,
                                          global_masked_means, local_world_size,
                                          make_hybrid_mesh, make_mesh, make_sharded_train_step,
                                          rank_values, replicate, shard_batch, sum_metrics)
from pips_tpu_torch.train.config import (TrainConfig, parse_cli, resolve_dtype,
                                         resolve_fuse_chanff)
from pips_tpu_torch.train.optim import Optimizer, make_optimizer
from pips_tpu_torch.train.step import make_train_step, train_loss_fn
from pips_tpu_torch.utils import SimplePool, flax_msgpack, saverloader
from pips_tpu_torch.utils.logging import MetricWriter

METRIC_KEYS = ("total_loss", "seq", "vis", "ce", "ate_all", "ate_vis", "ate_occ")


def build_dataset(cfg: TrainConfig, split: str = "train"):
    if cfg.dataset == "synthetic":
        return SyntheticPointDataset(S=cfg.S, N=cfg.N, H=cfg.crop_size[0],
                                     W=cfg.crop_size[1],
                                     seed=125 if split == "train" else 9125)
    if cfg.dataset == "flyingthings":
        return FlyingThingsDataset(
            dataset_location=cfg.dataset_location,
            dset="TRAIN" if split == "train" else "TEST",
            subset=cfg.subset if split == "train" else "all",
            use_augs=cfg.use_augs, N=cfg.N, S=cfg.S, crop_size=tuple(cfg.crop_size))
    if cfg.dataset == "pointodyssey":
        return PointOdysseyDataset(
            dataset_location=cfg.dataset_location,
            dset="train" if split == "train" else "val",
            use_augs=cfg.use_augs, N=cfg.N, S=cfg.S, crop_size=tuple(cfg.crop_size))
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def init_state(cfg: TrainConfig, device="cuda", seed: int = 0) -> tuple[Pips | Pips2, Optimizer]:
    """The model (parameters from ``init_params(seed)``, in train mode on
    ``device``) and its optimizer over ``max_iters // grad_acc`` steps. For
    ``model_family="pips2"`` a ``Pips2`` whose refiner is ``mixer_dim`` wide
    and ``mixer_depth`` deep (PIPs++'s own 256 x 6 by the CLI), as the JAX
    loop builds it: no remat or ``fuse_conv3`` fields there."""
    device = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    fuse_chanff = resolve_fuse_chanff(cfg.fuse_chanff, dtype, device)
    if cfg.model_family == "pips2":
        model = Pips2(stride=cfg.stride, latent_dim=cfg.latent_dim,
                      corr_levels=cfg.corr_levels, corr_radius=cfg.corr_radius,
                      refiner_dim=cfg.mixer_dim, refiner_depth=cfg.mixer_depth, dtype=dtype,
                      fuse_chanff=fuse_chanff)
    else:
        model = Pips(S=cfg.S, stride=cfg.stride, latent_dim=cfg.latent_dim,
                     corr_levels=cfg.corr_levels, corr_radius=cfg.corr_radius,
                     mixer_dim=cfg.mixer_dim, mixer_depth=cfg.mixer_depth, dtype=dtype,
                     remat_mixer=cfg.remat_mixer, remat_corr=cfg.remat_corr,
                     remat_encoder=cfg.remat_encoder, fuse_chanff=fuse_chanff,
                     fuse_conv3=resolve_fuse_chanff(cfg.fuse_conv3, dtype, device))
    model = init_params(model, seed).to(device).train()
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.max_iters // cfg.grad_acc,
                         wdecay=cfg.wdecay, use_scheduler=cfg.use_scheduler)
    return model, opt


def restore(cfg: TrainConfig, model: Pips, opt: Optimizer, ckpt_dir: str) -> int:
    """Auto-resume from this run's own latest checkpoint (the model, the
    optimizer's full state and the step) when one exists and no ``init_dir``
    is given; else warm-start from ``init_dir`` (with ``load_optimizer``,
    ``load_step`` and ``ignore_load``). Returns the step to continue from."""
    if cfg.auto_resume and not cfg.init_dir and saverloader.list_steps(ckpt_dir):
        state, step = saverloader.load(ckpt_dir, {"model": model.state_dict(),
                                                  "optimizer": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optimizer"])
        print(f"auto-resumed from {ckpt_dir} at step {step}")
        return step
    if cfg.init_dir and not saverloader.list_steps(cfg.init_dir) \
            and flax_msgpack.list_steps(cfg.init_dir):
        return warm_start_from_jax(cfg, model, opt)
    if cfg.init_dir:
        target = {"model": model.state_dict()}
        if cfg.load_optimizer:
            target["optimizer"] = opt.state_dict()
        state, step = saverloader.load(cfg.init_dir, target, ignore_load=cfg.ignore_load)
        model.load_state_dict(state["model"])
        if cfg.load_optimizer:
            opt.load_state_dict(state["optimizer"])
        return step if cfg.load_step else 0
    return 0


def _optax_chain(opt_state) -> tuple[dict, dict]:
    """(adam, schedule) states of the JAX loop's optax chain
    (``pips_tpu/train/optim.py:make_optimizer``): clip_by_global_norm, then
    adamw's scale_by_adam, add_decayed_weights and scale_by_learning_rate,
    serialized by flax with tuples as maps keyed "0", "1", ...:
    ``{"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {count}}}``."""
    try:
        adam, decay, schedule = (opt_state["1"][k] for k in "012")
        ok = (set(opt_state) == {"0", "1"} and opt_state["0"] == {} and decay == {}
              and set(opt_state["1"]) == {"0", "1", "2"} and set(adam) == {"count", "mu", "nu"}
              and set(schedule) == {"count"})
    except (KeyError, TypeError):
        ok = False
    if not ok:
        raise ValueError("the checkpoint's opt_state is not the JAX loop's clip -> adamw chain")
    return adam, schedule


def _keep_ignored(tree, target, path: str, ignore: list[str]):
    """``tree`` with each leaf whose JAX key path (``jax.tree_util.keystr``)
    holds one of the ``ignore`` substrings taken from ``target``."""
    if not ignore:
        return tree
    if isinstance(tree, dict):
        return {k: _keep_ignored(v, target[k], f"{path}['{k}']", ignore) for k, v in tree.items()}
    if any(ig in path for ig in ignore):
        print(f"-- ignoring load of {path}")
        return target
    return tree


def warm_start_from_jax(cfg: TrainConfig, model: Pips, opt: Optimizer) -> int:
    """Warm start from the largest step of ``cfg.init_dir``, a directory of the
    JAX package's ``model-*.msgpack`` checkpoints, as its loop does
    (``pips_tpu/train/loop.py:140-155``): the parameters, and with
    ``load_optimizer`` the optax moments, Adam count and schedule position
    (``Optimizer.load_optax_state``); leaves whose JAX key path
    (``.params['params']['fnet']...``, ``.opt_state[1][0].mu[...]``, or
    ``['params'][...]`` without the optimizer) holds an ``ignore_load``
    substring keep their fresh values (parameters from the init, moments and
    counts 0). Returns the checkpoint's step with ``load_step``, else 0.

    Without ``load_optimizer`` the parameters come from a bare variables tree
    or from a train state's ``params``; the JAX loop takes only the former."""
    raw, step = flax_msgpack.load_raw(cfg.init_dir)
    full = isinstance(raw, dict) and {"opt_state", "step", "params"} <= set(raw)
    if cfg.load_optimizer and not full:
        raise ValueError(f"load_optimizer: the checkpoint in {cfg.init_dir} holds no train "
                         f"state (top-level keys {sorted(raw)})")
    ignore = [cfg.ignore_load] if isinstance(cfg.ignore_load, str) else list(cfg.ignore_load or [])
    fresh = flax_from_state_dict(model.state_dict())
    prefix = ".params" if cfg.load_optimizer else ""
    variables = raw["params"] if full else raw
    load_flax_params(model, _keep_ignored(variables, fresh, prefix, ignore))
    if cfg.load_optimizer:
        adam, schedule = _optax_chain(raw["opt_state"])
        zeros = {"params": _zeros_like(fresh["params"])}
        moments = [state_dict_from_flax(_keep_ignored(adam[k], zeros,
                                                      f".opt_state[1][0].{k}", ignore))
                   for k in ("mu", "nu")]
        counts = [int(_keep_ignored(c, 0, path, ignore)) for c, path in
                  ((adam["count"], ".opt_state[1][0].count"),
                   (schedule["count"], ".opt_state[1][2].count"))]
        opt.load_optax_state(dict(model.named_parameters()), *moments, *counts)
    print(f"warm-started from the JAX checkpoint in {cfg.init_dir} at step {step}")
    return step if cfg.load_step else 0


def _zeros_like(tree):
    return ({k: _zeros_like(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.zeros_like(tree))


def _host(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _pool_update(pools: dict, metrics: dict) -> None:
    for k, pool in pools.items():
        v = metrics[k]
        # ate_* are masked means that return 0 when the mask is empty (e.g. no
        # occluded points in the batch): skip those; loss terms pool always
        if v > 0 or not k.startswith("ate_"):
            pool.update([v])


def _log_media(model: Pips, cfg: TrainConfig, vis_batch, writer: MetricWriter,
               global_step: int) -> None:
    """Re-track the fixed probe batch and render its trajectories (and, up to
    384x512 frames, the score maps of point 0) into ``<log_dir>/media``."""
    from pips_tpu_torch.utils.improc import Summ_writer, render_fcp_vis

    vb, vb_dev, want_fcp = vis_batch
    with torch.no_grad():
        out = model(vb_dev["trajs"][:, 0], vb_dev["rgbs"], iters=cfg.I, is_train=False,
                    compute_fcp=want_fcp)
    preds = out.coord_predictions.float().cpu().numpy()               # (I, 1, S, NV, 2)
    sw = Summ_writer(writer, global_step, log_freq=cfg.log_freq)
    rgbs8 = np.clip(vb["rgbs"][0], 0, 255).astype(np.uint8)           # (S, H, W, 3)
    vis_p = 1.0 / (1.0 + np.exp(-out.vis_e[0].float().cpu().numpy()))  # (S, NV)
    sw.summ_traj2ds_on_rgbs("train/trajs_on_rgbs", preds[-1][0], rgbs8, visibles=vis_p)
    if out.fcps is not None:
        fcps = out.fcps[0, :, :, 0].float().cpu().numpy()               # (S, I, H8, W8)
        sw.summ_rgbs("train/fcp_point0", list(render_fcp_vis(
            fcps, preds[:, 0, :, 0], trajs_g=vb["trajs"][0, :, 0], stride=cfg.stride)))


def join_mesh(cfg: TrainConfig, device) -> tuple[Optional[DeviceMesh], int]:
    """(mesh, hosts) for ``cfg``: (None, 1) for a lone process with no mesh
    asked. Otherwise the process joins the group (``--coordinator``,
    ``--num_processes``, ``--process_id``, or a launcher's environment) and
    the mesh holds its processes, one per device: ``--mesh_shape``, by
    default ``default_mesh_shape``; with ``--multihost`` the hosts stack on
    the data axis (``make_hybrid_mesh``, each host's block ``--mesh_shape``,
    by default its processes on the data axis) and ``hosts`` counts them."""
    shape = None if cfg.mesh_shape is None else tuple(cfg.mesh_shape)
    if not (cfg.multihost or cfg.num_processes > 1 or dist.is_initialized()
            or int(os.environ.get("WORLD_SIZE", 1)) > 1
            or (shape is not None and math.prod(shape) > 1)):
        return None, 1
    distributed_init(cfg.coordinator or None, cfg.num_processes or None, cfg.process_id,
                     device=device)
    world = dist.get_world_size()
    if cfg.multihost:
        hosts = max(world // local_world_size(), 1)
        return make_hybrid_mesh(shape or (local_world_size(), 1), hosts, device), hosts
    return make_mesh(shape or default_mesh_shape(world, cfg.B, cfg.N), device), 1


def _shards(it, mesh: DeviceMesh, grad_acc: int, hosts: int):
    """This process's ``shard_batch`` slice of each batch of ``it``."""
    try:
        for batch in it:
            yield shard_batch(mesh, batch, grad_acc, hosts)
    finally:
        it.close()


def train(cfg: Optional[TrainConfig] = None, device="cuda") -> dict:
    """Train ``cfg``'s model; returns the last synced metrics (floats).

    With a mesh (``join_mesh``) every process runs this loop: it loads the
    whole batch (with ``--multihost`` its host's, seeded ``125 + 1000 *
    host`` as the JAX loop seeds each host) and trains on its slice through
    ``make_sharded_train_step``; process 0 alone logs, renders media and
    writes checkpoints, and every process checks that all resumed at the
    same step."""
    cfg = cfg or TrainConfig()
    if cfg.quick:  # smoke mode
        cfg = dataclasses.replace(cfg, B=1, N=16, max_iters=20, crop_size=(128, 192),
                                  use_augs=False, dataset="synthetic", log_freq=10,
                                  val_freq=10, save_freq=10, mesh_shape=(1, 1))
    device = resolve_device(device)
    mesh, hosts = join_mesh(cfg, device)
    if device.type == "cuda":  # the card distributed_init gave this process
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if mesh is not None else 0
    is_main = rank == 0

    name = cfg.model_name()
    if is_main:
        print("model_name", name)
    model, opt = init_state(cfg, device)
    ckpt_dir = f"{cfg.ckpt_dir}/{name}"
    global_step = restore(cfg, model, opt, ckpt_dir)
    if mesh is not None:
        # checkpoints come from process 0 alone, so every process must read
        # the same ckpt_dir; a divergent resume would mix restored and fresh
        # parameters and run different step counts into the collectives
        steps = rank_values(global_step, device)
        if min(steps) != max(steps):
            raise RuntimeError(
                "auto-resume divergence: processes found checkpoint steps "
                f"{sorted(set(int(s) for s in steps))}; ckpt_dir must be a "
                "filesystem shared by all hosts")
        replicate(model)
    if global_step >= cfg.max_iters and is_main:
        print(f"{ckpt_dir} is already at step {global_step} >= max_iters={cfg.max_iters}; "
              f"nothing to train (pass --auto_resume false or a new --exp_name to start fresh)")

    if mesh is None:
        step_fn = make_train_step(model, opt, iters=cfg.I, horz_flip=cfg.horz_flip,
                                  vert_flip=cfg.vert_flip, grad_acc=cfg.grad_acc, remat=cfg.remat,
                                  sync_metrics=False, use_fused_corr=cfg.use_fused_corr)
    else:
        step_fn = make_sharded_train_step(
            model, opt, mesh, iters=cfg.I, horz_flip=cfg.horz_flip, vert_flip=cfg.vert_flip,
            grad_acc=cfg.grad_acc, use_fused_corr=cfg.use_fused_corr, remat=cfg.remat,
            sync_metrics=False)
    # the JAX loop's seed for each host's loader
    seed0 = 125 + 1000 * (rank // local_world_size() if cfg.multihost else 0)

    def feed(it, grad_acc: int) -> DevicePrefetcher:
        return DevicePrefetcher(it if mesh is None else _shards(it, mesh, grad_acc, hosts),
                                device=device)

    train_it = feed(batch_iterator(build_dataset(cfg, "train"), cfg.B, shuffle=cfg.shuffle,
                                   seed=seed0, grad_acc=cfg.grad_acc,
                                   num_workers=cfg.num_workers,
                                   use_processes=cfg.loader_processes), cfg.grad_acc)
    val_it = None
    if cfg.val_freq > 0:
        val_it = feed(batch_iterator(build_dataset(cfg, "val"), cfg.B, shuffle=True, seed=seed0,
                                     num_workers=max(cfg.num_workers // 2, 1)), 1)

    writer = MetricWriter(f"{cfg.log_dir}/{name}") if is_main else None

    # visual summary probe: a small fixed batch re-tracked every log_freq
    # steps and rendered on the host
    vis_batch = None
    if cfg.log_media and cfg.log_freq > 0 and is_main:
        NV = min(16, cfg.N)
        probe = batch_iterator(build_dataset(cfg, "train"), 1, shuffle=True, seed=777,
                               num_workers=1)
        vb = next(probe)
        probe.close()
        vb = {k: (v if k == "rgbs" else v[:, :, :NV]) for k, v in vb.items()}
        # the score maps are a second forward variant; above 384x512 frames
        # only the trajectories are rendered, as in the JAX loop
        want_fcp = vb["rgbs"].shape[2] * vb["rgbs"].shape[3] <= 384 * 512
        vb_dev = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in vb.items()}
        vis_batch = (vb, vb_dev, want_fcp)
    pools = {k: SimplePool(100) for k in METRIC_KEYS}
    # validation pools persist across validation passes
    val_pools = {k: SimplePool(10000) for k in METRIC_KEYS}

    prof = None
    last_metrics = {}
    try:
        while global_step < cfg.max_iters:
            global_step += 1
            if cfg.profile_dir and global_step == 10:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if prof is not None and global_step == 15:
                prof.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(cfg.profile_dir, "steps_10_15.json"))
                prof = None
            t0 = time.time()
            batch = next(train_it)
            read_time = time.time() - t0
            metrics = step_fn(batch)
            sync = (global_step % max(cfg.metrics_every, 1) == 0
                    or global_step == cfg.max_iters)
            if sync:
                metrics = _host(metrics)
                _pool_update(pools, metrics)
            iter_time = time.time() - t0
            if sync and is_main and global_step % max(cfg.log_freq // 100, 1) == 0:
                writer.scalars(global_step, {f"pooled/{k}": p.mean() for k, p in pools.items()})

            if vis_batch is not None and global_step % cfg.log_freq == 0:
                _log_media(model, cfg, vis_batch, writer, global_step)

            if val_it is not None and global_step % cfg.val_freq == 0:
                # validation pass: cfg.val_batches held-out batches, pooled
                for _ in range(max(cfg.val_batches, 1)):
                    with torch.no_grad(), global_masked_means(mesh):
                        _, vmetrics = train_loss_fn(model, next(val_it), cfg.I, is_train=False,
                                                    use_fused_corr=cfg.use_fused_corr)
                    vmetrics = _host(vmetrics if mesh is None else sum_metrics(vmetrics))
                    _pool_update(val_pools, vmetrics)
                if is_main:
                    writer.scalars(global_step, {
                        **{f"val/{k}": v for k, v in vmetrics.items()},
                        **{f"val_pooled/{k}": p.mean() for k, p in val_pools.items() if p.items}})

            if global_step % cfg.save_freq == 0 and is_main:
                saverloader.save(ckpt_dir, {"model": model.state_dict(),
                                            "optimizer": opt.state_dict()},
                                 global_step, keep_latest=cfg.keep_latest)

            if sync and is_main:
                last_metrics = metrics
                print(f"{name}; step {global_step:06d}/{cfg.max_iters}; "
                      f"rtime {read_time:.3f}; itime {iter_time:.3f}; "
                      f"loss = {last_metrics['total_loss']:.5f}", flush=True)
    finally:
        if prof is not None:
            prof.stop()
        train_it.close()
        if val_it is not None:
            val_it.close()
        if writer is not None:
            writer.close()
    return last_metrics


def main(argv: Optional[list[str]] = None) -> dict:
    """The CLI: parse ``argv`` (``sys.argv[1:]`` by default) onto a
    ``TrainConfig`` and train on CUDA; returns the last synced metrics."""
    return train(parse_cli(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    main()
