"""FlyingThings++ eval (counterpart of ``pips_tpu/evals/run_flt.py``;
capability parity: reference ``test_on_flt.py``).

Reports pooled ate_all / ate_vis / ate_occ with the per-sequence visibility
relabeling ("visible in >= 4 frames"). Runs on CUDA unless ``--device cpu``;
``--dtype bfloat16`` serves every window through the fused channel-block
kernel; ``--modeltype raft|dino`` runs a baseline instead (f32, ``--init_dir``
its weights file). Usage:

    python -m pips_tpu_torch.evals.run_flt --init_dir <ckpt> --dataset_location <flt>
"""

from __future__ import annotations

import time

import numpy as np

from pips_tpu_torch.data.flyingthings import FlyingThingsDataset
from pips_tpu_torch.evals.metrics import ate_metrics, per_seq_vis_label
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.utils import SimplePool
from pips_tpu_torch.utils.logging import MetricWriter


def _build_tracker(modeltype: str, init_dir: str, S: int, stride: int, iters: int,
                   dtype: str = "float32", raft_iters: int = 32, device="cuda"):
    """Returns fn(trajs_g0 (1,N,2), rgbs (1,S,H,W,3)) -> trajs_e (1,S,N,2)."""
    if modeltype == "pips":
        from pips_tpu_torch.evals.common import build_pips_tracker
        return build_pips_tracker(init_dir, S=S, stride=stride, iters=iters,
                                  dtype=dtype, device=device)

    from pips_tpu_torch.evals.common import build_baseline_tracker
    return build_baseline_tracker(modeltype, init_dir, raft_iters=raft_iters, device=device)


def main(init_dir: str = "checkpoints/ref", dataset_location: str = "/data/flyingthings",
         S: int = 8, N: int = 16, stride: int = 8, iters: int = 6,
         crop_size=(384, 512), max_iters: int = 0, log_dir: str = "logs_test_on_flt",
         subset: str = "all", shuffle: bool = True, modeltype: str = "pips",
         dtype: str = "float32", raft_iters: int = 32, log_freq: int = 0,
         device: str = "cuda"):
    resolve_device(device)
    tracker = _build_tracker(modeltype, init_dir, S, stride, iters,
                             dtype=dtype, raft_iters=raft_iters, device=device)

    dataset = FlyingThingsDataset(
        dataset_location=dataset_location, dset="TEST", subset=subset,
        use_augs=False, N=N, S=S, crop_size=tuple(crop_size))
    max_iters = max_iters or len(dataset)

    writer = MetricWriter(log_dir)
    pools = {k: SimplePool(10000) for k in ("ate_all", "ate_vis", "ate_occ")}
    step = 0
    idx = np.random.RandomState(125).permutation(len(dataset)) if shuffle \
        else np.arange(len(dataset))
    for i in idx:
        if step >= max_iters:
            break
        sample, gotit = dataset[int(i)]
        if not gotit:
            continue
        step += 1
        rgbs = sample["rgbs"][None]
        trajs_g = sample["trajs"][None]
        valids = sample["valids"][None]
        vis_g = per_seq_vis_label(sample["visibles"][None], min_frames=4)

        t0 = time.time()
        trajs_e = tracker(trajs_g[:, 0], rgbs)
        m = ate_metrics(trajs_e, trajs_g, valids, vis_g)
        for k, p in pools.items():
            if m[k] > 0:
                p.update([m[k]])
        print(f"step {step:06d}/{max_iters}; itime {time.time() - t0:.2f}; "
              + "; ".join(f"{k} {p.mean():.2f}" for k, p in pools.items()))
        writer.scalars(step, {f"pooled/{k}": p.mean() for k, p in pools.items()})
        if log_freq and step % log_freq == 0:
            from pips_tpu_torch.evals.common import emit_eval_media
            emit_eval_media(writer, step, rgbs[0], trajs_g[0], trajs_e[0],
                            valids[0], m["ate_all"])
    writer.close()
    return {k: p.mean() for k, p in pools.items()}


if __name__ == "__main__":
    from pips_tpu_torch.utils.cli import auto_cli
    print(auto_cli(main))
