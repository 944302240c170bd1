"""CroHD head-tracking eval (counterpart of ``pips_tpu/evals/run_crohd.py``;
capability parity: reference ``test_on_crohd.py``).

Runs the S=8 (of 24, stride-3) windows through the model and reports pooled
ATE over the visible and occluded head subsets (reference expected values:
ate_vis 4.57, ate_occ 7.71 — ``test_on_crohd.py:245-246``). Runs on CUDA
unless ``--device cpu``; ``--modeltype raft|dino`` runs the RAFT flow chain
or DINO label propagation over each window (``--init_dir`` their weights
file).

    python -m pips_tpu_torch.evals.run_crohd --init_dir <ckpt> --dataset_root <ht21>
"""

from __future__ import annotations

import time

import numpy as np

from pips_tpu_torch.data.crohd import CrohdDataset, prep_sample
from pips_tpu_torch.evals.metrics import ate_metrics
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.utils import SimplePool


def main(init_dir: str = "checkpoints/ref", dataset_root: str = "/data/head_tracking",
         S: int = 8, N: int = 16, stride: int = 4, iters: int = 6,
         max_iters: int = 0, req_occlusion: bool = True, dset: str = "t",
         dtype: str = "float32", modeltype: str = "pips", raft_iters: int = 32,
         log_freq: int = 0, log_dir: str = "logs_test_on_crohd", device: str = "cuda"):
    resolve_device(device)
    if modeltype == "pips":
        from pips_tpu_torch.evals.common import build_pips_tracker
        track = build_pips_tracker(init_dir, S=S, stride=stride, iters=iters,
                                   dtype=dtype, device=device)
    else:
        from pips_tpu_torch.evals.common import build_baseline_tracker
        track = build_baseline_tracker(modeltype, init_dir, raft_iters=raft_iters,
                                       device=device)

    dataset = CrohdDataset(seqlen=S * 3, dset=dset, dataset_root=dataset_root)
    max_iters = max_iters or len(dataset)

    pools = {k: SimplePool(10000) for k in ("ate_all", "ate_vis", "ate_occ")}
    writer = None
    for step in range(max_iters):
        raw = dataset[step]
        d, ok = prep_sample(raw, N_max=N, S_stride=3, req_occlusion=req_occlusion)
        if not ok:
            continue
        # pad/truncate to a fixed N, as the JAX runner does for its jit shapes
        n = d["trajs_g"].shape[2]
        if n < N:
            pad = N - n
            d["trajs_g"] = np.concatenate(
                [d["trajs_g"], np.repeat(d["trajs_g"][:, :, :1], pad, 2)], axis=2)
            d["vis_g"] = np.concatenate(
                [d["vis_g"], np.repeat(d["vis_g"][:, :, :1], pad, 2)], axis=2)
            valids = np.concatenate(
                [np.ones((1, S, n)), np.zeros((1, S, pad))], axis=2).astype(np.float32)
        else:
            valids = np.ones((1, S, N), np.float32)

        t0 = time.time()
        trajs_e = track(d["trajs_g"][:, 0], d["rgbs"])
        m = ate_metrics(np.asarray(trajs_e), d["trajs_g"], valids, d["vis_g"])
        for k, p in pools.items():
            if m[k] > 0:
                p.update([m[k]])
        print(f"step {step + 1:04d}/{max_iters}; itime {time.time() - t0:.2f}; "
              + "; ".join(f"{k} {p.mean():.2f}" for k, p in pools.items()))
        if log_freq and step % log_freq == 0:
            from pips_tpu_torch.evals.common import emit_eval_media
            from pips_tpu_torch.utils.logging import MetricWriter
            if writer is None:
                writer = MetricWriter(log_dir, use_tensorboard=False)
            emit_eval_media(writer, step, d["rgbs"][0], d["trajs_g"][0],
                            np.asarray(trajs_e)[0], valids[0], m["ate_all"])
    if writer is not None:
        writer.close()
    return {k: p.mean() for k, p in pools.items()}


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    print(auto_cli(main))
