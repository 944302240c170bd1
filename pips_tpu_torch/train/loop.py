"""The train loop (counterpart of ``pips_tpu/train/loop.py``).

    python -m pips_tpu_torch.train.loop --dataset synthetic --fuse_conv3 1 ...

Composes: dataset -> host batcher -> CUDA prefetch -> train step -> pooled
metric logging -> periodic validation, media and checkpointing with
auto-resume. Runs on CUDA unless the caller passes ``device="cpu"``.

``model_family="pips2"`` trains the S-agnostic PIPs++ family (``Pips2``), its
refiner ``mixer_dim`` wide and ``mixer_depth`` deep, as the JAX loop builds it.
Not ported yet, and refused with the ROADMAP item that brings them: the
FlyingThings++ and PointOdyssey sets (A4, data) and data-parallel or
multi-host runs (A7, parallel). The JAX loop's compile cache has no
counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from pips_tpu_torch.data import DevicePrefetcher, SyntheticPointDataset, batch_iterator
from pips_tpu_torch.models.pips import Pips, init_params, resolve_device
from pips_tpu_torch.models.pips2 import Pips2
from pips_tpu_torch.train.config import (TrainConfig, parse_cli, resolve_dtype,
                                         resolve_fuse_chanff)
from pips_tpu_torch.train.optim import Optimizer, make_optimizer
from pips_tpu_torch.train.step import make_train_step, train_loss_fn
from pips_tpu_torch.utils import SimplePool, saverloader
from pips_tpu_torch.utils.logging import MetricWriter

METRIC_KEYS = ("total_loss", "seq", "vis", "ce", "ate_all", "ate_vis", "ate_occ")


def build_dataset(cfg: TrainConfig, split: str = "train"):
    if cfg.dataset == "synthetic":
        return SyntheticPointDataset(S=cfg.S, N=cfg.N, H=cfg.crop_size[0],
                                     W=cfg.crop_size[1],
                                     seed=125 if split == "train" else 9125)
    if cfg.dataset in ("flyingthings", "pointodyssey"):
        raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported yet (ROADMAP A4, "
                                  f"data); use --dataset synthetic")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _refuse_unported(cfg: TrainConfig) -> None:
    mesh = None if cfg.mesh_shape is None else tuple(cfg.mesh_shape)
    if cfg.multihost or cfg.num_processes > 1 or mesh not in (None, (1, 1)):
        raise NotImplementedError("multi-device and multi-host training are not ported yet "
                                  "(ROADMAP A7, parallel); run with mesh_shape None or (1, 1)")


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


def train(cfg: Optional[TrainConfig] = None, device="cuda") -> dict:
    """Train ``cfg``'s model; returns the last synced metrics (floats)."""
    cfg = cfg or TrainConfig()
    if cfg.quick:  # smoke mode
        cfg = dataclasses.replace(cfg, B=1, N=16, max_iters=20, crop_size=(128, 192),
                                  use_augs=False, dataset="synthetic", log_freq=10,
                                  val_freq=10, save_freq=10, mesh_shape=(1, 1))
    _refuse_unported(cfg)
    device = resolve_device(device)

    name = cfg.model_name()
    print("model_name", name)
    model, opt = init_state(cfg, device)
    ckpt_dir = f"{cfg.ckpt_dir}/{name}"
    global_step = restore(cfg, model, opt, ckpt_dir)
    if global_step >= cfg.max_iters:
        print(f"{ckpt_dir} is already at step {global_step} >= max_iters={cfg.max_iters}; "
              f"nothing to train (pass --auto_resume false or a new --exp_name to start fresh)")

    step_fn = make_train_step(model, opt, iters=cfg.I, horz_flip=cfg.horz_flip,
                              vert_flip=cfg.vert_flip, grad_acc=cfg.grad_acc, remat=cfg.remat,
                              sync_metrics=False, use_fused_corr=cfg.use_fused_corr)
    seed0 = 125  # the JAX loop's, for its process 0
    train_it = DevicePrefetcher(
        batch_iterator(build_dataset(cfg, "train"), cfg.B, shuffle=cfg.shuffle, seed=seed0,
                       grad_acc=cfg.grad_acc, num_workers=cfg.num_workers,
                       use_processes=cfg.loader_processes),
        device=device)
    val_it = None
    if cfg.val_freq > 0:
        val_it = DevicePrefetcher(
            batch_iterator(build_dataset(cfg, "val"), cfg.B, shuffle=True, seed=seed0,
                           num_workers=max(cfg.num_workers // 2, 1)),
            device=device)

    writer = MetricWriter(f"{cfg.log_dir}/{name}")

    # visual summary probe: a small fixed batch re-tracked every log_freq
    # steps and rendered on the host
    vis_batch = None
    if cfg.log_media and cfg.log_freq > 0:
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
            if sync and global_step % max(cfg.log_freq // 100, 1) == 0:
                writer.scalars(global_step, {f"pooled/{k}": p.mean() for k, p in pools.items()})

            if vis_batch is not None and global_step % cfg.log_freq == 0:
                _log_media(model, cfg, vis_batch, writer, global_step)

            if val_it is not None and global_step % cfg.val_freq == 0:
                # validation pass: cfg.val_batches held-out batches, pooled
                for _ in range(max(cfg.val_batches, 1)):
                    with torch.no_grad():
                        _, vmetrics = train_loss_fn(model, next(val_it), cfg.I, is_train=False,
                                                    use_fused_corr=cfg.use_fused_corr)
                    vmetrics = _host(vmetrics)
                    _pool_update(val_pools, vmetrics)
                writer.scalars(global_step, {
                    **{f"val/{k}": v for k, v in vmetrics.items()},
                    **{f"val_pooled/{k}": p.mean() for k, p in val_pools.items() if p.items}})

            if global_step % cfg.save_freq == 0:
                saverloader.save(ckpt_dir, {"model": model.state_dict(),
                                            "optimizer": opt.state_dict()},
                                 global_step, keep_latest=cfg.keep_latest)

            if sync:
                last_metrics = metrics
                print(f"{name}; step {global_step:06d}/{cfg.max_iters}; "
                      f"rtime {read_time:.2f}; itime {iter_time:.2f}; "
                      f"loss = {last_metrics['total_loss']:.5f}", flush=True)
    finally:
        if prof is not None:
            prof.stop()
        train_it.close()
        if val_it is not None:
            val_it.close()
        writer.close()
    return last_metrics


def main(argv: Optional[list[str]] = None) -> dict:
    """The CLI: parse ``argv`` (``sys.argv[1:]`` by default) onto a
    ``TrainConfig`` and train on CUDA; returns the last synced metrics."""
    return train(parse_cli(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    main()
