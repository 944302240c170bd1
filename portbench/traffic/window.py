"""Closed-loop serving: one caller sends an S-frame window and its query
points to ``WindowTracker.__call__`` and waits for the numpy results before
sending the next, as ``evals/run_*.py`` and ``demo.py`` call the port.

The workload file's ``params``: frame size ``H`` x ``W``; the clip pool
(``pool_clips`` clips of the frozen synthetic generator with ``sprites``
sprites of ``sprite_size`` px moving up to ``max_vel`` px a frame), cycled
one clip a window; the queries (``"dense"``: every ``query_stride``-th pixel,
as ``dense_queries``; ``"grid"``: a ``grid`` x ``grid`` lattice inside an
8 px margin, as ``grid_queries``); ``iters`` and ``corr_mode``;
``warmup_windows`` before the clock starts; ``profiled_calls`` whole windows
and ``profiled_windows`` split ones traced after the window when asked;
``checked_windows`` drawn from the seed among those served and held to the
plain reference.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, trace
from portbench.reference import pips as ref
from portbench.reference.params import make_params
from portbench.roofline import forward_flops

PARTS = ("encode", "track")


def queries(p: dict) -> np.ndarray:
    """(1, N, 2) xy query points."""
    H, W = p["H"], p["W"]
    if p["queries"] == "dense":
        s = p["query_stride"]
        gy, gx = np.meshgrid(np.arange(H // s) * s, np.arange(W // s) * s, indexing="ij")
    elif p["queries"] == "grid":
        gy, gx = np.meshgrid(np.linspace(8, H - 8, p["grid"]), np.linspace(8, W - 8, p["grid"]),
                             indexing="ij")
    else:
        raise ValueError(f"queries are 'dense' or 'grid', got {p['queries']!r}")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)[None].astype(np.float32)


def make_tracker(ctx, params: dict):
    from pips_tpu_torch.inference.window import WindowTracker

    p = ctx.params
    model = common.build_model(ctx.model, params, ctx.device, train=False)
    return WindowTracker(model, iters=p["iters"], corr_mode=p["corr_mode"], device=ctx.device)


def serve(tracker, frames: list, xys: np.ndarray, seconds: float):
    """Windows until ``seconds`` have passed: the clip of window i is
    ``frames[i % len(frames)]``. Returns (latencies s, outputs, seconds)."""
    lat, outs = [], []
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        outs.append(tracker(xys, frames[len(lat) % len(frames)]))
        b = time.perf_counter()
        lat.append(b - a)
        if b - start >= seconds:
            return lat, outs, b - start


def profile(ctx, tracker, frames: list, xys: np.ndarray) -> dict:
    """Two profiled sections after the window, in one profiler session
    (``trace.profiled``). ``profiled_calls`` whole
    ``tracker(xys, frames)`` calls, as the window makes them (numpy in, the
    port's own upload, forward and download, numpy out), a mark between
    calls and nothing else: the copies, the kernels and the device's idle
    share come from these. Then ``profiled_windows`` windows split into
    ``WindowTracker.encode`` and ``WindowTracker.track`` on the same numpy
    inputs, with a sync after each (``profile_window.py``'s split): the
    device time of each part comes from these."""
    import torch
    from pips_tpu_torch.kernels import mixer_cuda

    dev = torch.device(ctx.device)
    p = ctx.params
    state = {}

    def call(i, _):
        n = mixer_cuda.launches
        tracker(xys, frames[i % len(frames)])
        if i < 0:  # every window makes the same calls
            state["chanff_fwd"] = mixer_cuda.launches - n

    def part(i, name):
        if name == "encode":
            state["fmaps"] = tracker.encode(frames[i % len(frames)])
        else:
            state["out"] = tracker.track(state.pop("fmaps"), xys)
        common.sync(dev)

    whole, split = trace.profiled(dev, [(("call",), p["profiled_calls"], call),
                                        (PARTS, p["profiled_windows"], part)])
    return {"calls": whole, "parts": split,
            "chanff_fwd_calls": state["chanff_fwd"] * p["profiled_calls"]}


def check(ctx, frames: list, xys: np.ndarray, outs: list, sample_seed: int,
          precision: str = "float32") -> dict:
    """The served windows drawn from the seed, against the plain reference
    computed anew from the same weights and inputs (``precision`` "float8"
    gives the control). Each number is the worst over the windows."""
    import torch

    p, cfg = ctx.params, ctx.model
    rng = np.random.default_rng(sample_seed)
    picks = sorted(rng.choice(len(outs), size=min(p["checked_windows"], len(outs)),
                              replace=False).tolist())
    params = make_params(cfg, common.seeds(ctx.seed)["weights"], ctx.device)
    q = torch.as_tensor(xys).to(ctx.device)
    worst = {}
    with ref.reference_mode():
        for i in picks:
            rgbs = torch.as_tensor(frames[i % len(frames)]).to(ctx.device)
            t_ref, v_ref = ref.window(params, cfg, rgbs, q, p["iters"], ref.Precision(precision))
            for k, v in compare(outs[i], t_ref.cpu().numpy(), v_ref.cpu().numpy(), xys).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def compare(out, t_ref: np.ndarray, v_ref: np.ndarray, xys: np.ndarray) -> dict:
    """A window's gaps to the reference over frames 1.. (frame 0 is the
    query): the 90th percentile of the trajectory error over the point-frames
    as a share of the reference's rms displacement from the queries, and of
    the visibility logits' error as a share of their spread."""
    trajs, vis = out
    disp = np.sqrt(np.mean(np.sum((t_ref[:, 1:] - xys[:, None]) ** 2, -1)))
    err = np.sqrt(np.sum((trajs[:, 1:] - t_ref[:, 1:]) ** 2, -1))
    verr = np.abs(vis[:, 1:] - v_ref[:, 1:])
    return {"traj_err_p90": float(np.percentile(err, 90) / disp),
            "vis_err_p90": float(np.percentile(verr, 90) / np.std(v_ref[:, 1:]))}


def run(ctx) -> dict:
    p, cfg = ctx.params, ctx.model
    s = common.seeds(ctx.seed)
    params = make_params(cfg, s["weights"], ctx.device)
    tracker = make_tracker(ctx, params)
    del params
    frames = [c["rgbs"][None] for c in common.clip_pool(p, cfg["S"], s["traffic"])]
    xys = queries(p)
    for i in range(p["warmup_windows"]):
        tracker(xys, frames[i % len(frames)])
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t0
    lat, outs, window_s = serve(tracker, frames, xys, ctx.seconds)
    peak = common.peak_bytes(ctx.device)
    traced = profile(ctx, tracker, frames, xys) if ctx.trace else None
    del tracker
    common.free(ctx.device)
    failed = sum(not (np.isfinite(t).all() and np.isfinite(v).all()) for t, v in outs)
    limits = ctx.work["limits"]
    gaps = check(ctx, frames, xys, outs, s["sample"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    B, N = xys.shape[0], xys.shape[1]
    return {"kind": "window", "correct": common.judged(checks, failed), "attempted": len(outs),
            "failed": failed, "checks": checks, "setup_s": setup_s, "window_s": window_s,
            "latencies_s": lat, "units": len(outs), "point_frames": B * N * cfg["S"] * len(outs),
            "chanff_rows": B * N * cfg["S"], "dtype": cfg["dtype"],
            "forward_flops": forward_flops(cfg, B, cfg["S"], p["H"], p["W"], N, p["iters"]),
            "trace": traced,
            "device": common.device_info(ctx.device, ctx.cell["chips"], peak)}

