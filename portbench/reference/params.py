"""The PIPs parameters by name and shape, and their values from a seed.

The names and shapes are those of ``Pips.state_dict()`` in the port (and of
the JAX package's flax tree it maps): conv ``weight`` (O, I, k, k) and
``bias``; dense ``kernel`` (in, out) and ``bias``; norm ``scale`` and
``bias``. They are written out here from the published architecture, so the
benchmark needs nothing of the program to make them; ``load_state_dict``
(strict) in the harness checks that both sides agree.
"""

from __future__ import annotations

import math

import torch

STAGES = (64, 96, 128, 128)
# the refiner head's coordinate columns at a hundredth of fan-in scale: at
# fan-in scale untrained weights amplify rounding ~100x an iteration through
# the flow's sin/cos features (make_params)
COORD_HEAD_SCALE = 0.01


def param_shapes(cfg: dict) -> dict:
    """name -> shape, in the model's order."""
    out = {}
    C = cfg["latent_dim"]

    def conv(name, o, i, k):
        out[name + ".weight"] = (o, i, k, k)
        out[name + ".bias"] = (o,)

    def dense(name, i, o):
        out[name + ".kernel"] = (i, o)
        out[name + ".bias"] = (o,)

    def norm(name, d):
        out[name + ".scale"] = (d,)
        out[name + ".bias"] = (d,)

    conv("fnet.conv1", STAGES[0], 3, 7)
    c_in = STAGES[0]
    for i, dim in enumerate(STAGES):
        for j in range(2):
            name = f"fnet.layer{i + 1}_{j}"
            conv(name + ".conv1", dim, c_in, 3)
            conv(name + ".conv2", dim, dim, 3)
            if i > 0 and j == 0:
                conv(name + ".downsample", dim, c_in, 1)
            c_in = dim
    conv("fnet.conv2", 2 * C, sum(STAGES), 3)
    conv("fnet.conv3", C, 2 * C, 1)
    S, D, L, r = cfg["S"], cfg["mixer_dim"], cfg["corr_levels"], cfg["corr_radius"]
    kitchen = L * (2 * r + 1) ** 2 + C + 64 * 3 + 3
    pre = "delta_block.to_delta"
    dense(pre + ".embed", kitchen, D)
    for d in range(cfg["mixer_depth"]):
        norm(f"{pre}.block{d}_token_norm", D)
        dense(f"{pre}.block{d}_token.fc1", S, 4 * S)
        dense(f"{pre}.block{d}_token.fc2", 4 * S, S)
        norm(f"{pre}.block{d}_chan_norm", D)
        dense(f"{pre}.block{d}_chan.fc1", D, 4 * D)
        dense(f"{pre}.block{d}_chan.fc2", 4 * D, D)
    norm(pre + ".final_norm", D)
    dense(pre + ".head", D, S * (C + 2))
    norm("ffeat_norm", C)
    dense("ffeat_updater", C, C)
    dense("vis_predictor", C, 1)
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """name -> f32 tensor on ``device``, drawn from ``seed`` in one call: conv
    weights and dense kernels normal with variance 1 / fan_in, biases and
    norm biases with standard deviation 0.1, norm scales 1 plus that.

    The refiner's head then moves each point by about a stride an iteration
    in a random direction, and the sin/cos flow features (up to 984 radians
    a unit of flow) make each iteration amplify a coordinate's rounding
    ~100x: after six iterations the f32 program and the f32 reference are
    pixels apart, as are bf16 and float8. So the head's coordinate columns
    (and their biases) are scaled by ``COORD_HEAD_SCALE``, which makes
    the iterations converge as a trained tracker's do. The same seed gives
    the same tensors on the same kind of device."""
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), t in zip(shapes.items(), flat.split(sizes)):
        t = t.view(shape)
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight":
            t = t * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif leaf == "kernel":
            t = t * (1.0 / math.sqrt(shape[0]))
        elif leaf == "scale":
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t
    head = out["delta_block.to_delta.head.kernel"].view(cfg["mixer_dim"], cfg["S"], -1)
    head[:, :, :2] *= COORD_HEAD_SCALE
    out["delta_block.to_delta.head.bias"].view(cfg["S"], -1)[:, :2] *= COORD_HEAD_SCALE
    return out
