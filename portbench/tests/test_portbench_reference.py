"""The frozen reference against the port's plain CPU path at TINY widths, on
the same weights. The test imports both; the reference imports neither the
port, nor JAX, nor the JAX package."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import pips as ref
from portbench.reference.params import make_params, param_shapes

TINY = dict(S=8, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)
REF_DIR = Path(ref.__file__).resolve().parent


def port_model(cfg, params, train=False):
    from pips_tpu_torch.models.pips import Pips

    keys = ("S", "stride", "latent_dim", "corr_levels", "corr_radius", "mixer_dim", "mixer_depth")
    m = Pips(**{k: cfg[k] for k in keys})
    m.load_state_dict(params, strict=True)
    return m.train() if train else m.eval()


def inputs(seed, H=64, W=96, N=9):
    gen = torch.Generator().manual_seed(seed)
    rgbs = torch.rand(1, 8, H, W, 3, generator=gen) * 255
    trajs = torch.rand(1, 8, N, 2, generator=gen) * torch.tensor([W - 1.0, H - 1.0])
    vis = (torch.rand(1, 8, N, generator=gen) > 0.3).float()
    return {"rgbs": rgbs, "trajs": trajs, "visibles": vis, "valids": torch.ones(1, 8, N)}


@pytest.mark.parametrize("stride", [8, 4])
def test_parameter_names_and_shapes_are_the_ports(stride):
    cfg = dict(TINY, stride=stride)
    from pips_tpu_torch.models.pips import Pips

    keys = ("S", "stride", "latent_dim", "corr_levels", "corr_radius", "mixer_dim", "mixer_depth")
    want = {k: tuple(v.shape) for k, v in Pips(**{k: cfg[k] for k in keys}).state_dict().items()}
    assert param_shapes(cfg) == want


@pytest.mark.parametrize("stride, seed", [(8, 0), (4, 1)])
def test_window_matches_the_ports_plain_path(stride, seed):
    cfg = dict(TINY, stride=stride)
    p = make_params(cfg, seed, "cpu")
    b = inputs(seed)
    xys = b["trajs"][:, 0]
    with torch.no_grad():
        out = port_model(cfg, p)(xys, b["rgbs"], iters=6, corr_mode="onehot")
    t, v = ref.window(p, cfg, b["rgbs"], xys, 6, ref.Precision())
    disp = (t[:, 1:] - xys[:, None]).norm(dim=-1).pow(2).mean().sqrt()
    assert disp > 0.01
    assert (out.coord_predictions[-1] - t).norm(dim=-1).max() <= 1e-3 * disp
    assert (out.vis_e - v).abs().max() <= 1e-4 * v.abs().max()


def test_training_loss_and_grads_match_the_ports_plain_path():
    from pips_tpu_torch.train import apply_flip_doubling, train_loss_fn

    cfg = dict(TINY)
    p = make_params(cfg, 5, "cpu")
    b = inputs(5)
    model = port_model(cfg, p, train=True)
    loss, metrics = train_loss_fn(model, apply_flip_doubling(dict(b), True, True), 3)
    loss.backward()
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    rloss, terms = ref.train_loss(q, cfg, b, 3, ref.Precision())
    rloss.backward()
    assert float(rloss) == pytest.approx(float(loss), rel=1e-5)
    for k in ("seq", "vis", "ce"):
        assert float(terms[k]) == pytest.approx(float(metrics[k]), rel=1e-5)
    # the encoder's grads pass nine instance norms, whose statistics the two
    # sides sum in other orders and forms (E[x^2] - E[x]^2 against the
    # variance): up to ~1.4e-3 of a leaf at these widths, the rest ~1e-5
    grads = dict(model.named_parameters())
    med = np.median([float(q[k].grad.norm()) for k in q])
    for k in q:
        gap = (grads[k].grad - q[k].grad).norm() / max(float(q[k].grad.norm()), med)
        assert gap < (5e-3 if k.startswith("fnet.") else 1e-4), k


def test_adamw_matches_the_ports_optimizer():
    from pips_tpu_torch.train import make_optimizer

    gen = torch.Generator().manual_seed(2)
    start = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    mine = {k: v.clone() for k, v in start.items()}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in start.items()}
    adam = ref.AdamW(mine, 5e-4, 200000)
    opt = make_optimizer(theirs.values(), lr=5e-4, num_steps=200000)
    for step in range(3):
        g = {k: torch.randn(v.shape, generator=gen) * (10.0 if step == 0 else 0.1)
             for k, v in start.items()}
        opt.zero_grad()
        for k, v in theirs.items():
            v.grad = g[k].clone()
        opt.step()
        adam.step(g)
    for k in start:
        assert torch.allclose(mine[k], theirs[k].detach(), rtol=0, atol=1e-7)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted(REF_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"pips_tpu_torch", "pips_tpu", "jax", "jaxlib", "flax"}, path
