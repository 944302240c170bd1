"""The port's sharded train step against the JAX package's
``make_sharded_train_step``, on the same weights and the same global batch.

JAX runs its step as one computation over a mesh of the test session's
virtual CPU devices (tests/conftest.py); the port runs it in two processes
joined over gloo (``tests/test_torch_parallel.py``'s children), each on its
``shard_batch`` slice. Both take one refinement iteration with the
horizontal flip, as ``tests/test_torch_train.py`` does, so the bounds are
that file's: metrics within 1e-5 relative, every grad leaf in its class of
``assert_grads_match``. JAX's grads are read where its optimizer chain
starts, the port's where its optimizer's clip reads them, both after the
sum over the mesh. The updated parameters agree within two of the first
step's rate: Adam's first update is the rate times the grad's sign, so a
grad that rounds across zero moves its parameter by twice the rate, and
only those may differ by more than 1e-6: at most 1% of the parameters
(measured 1,316 to 1,418 of 1,790,241, 0.08%).

The JAX step compiles once per case (``lru_cache``); the file stands apart
from ``test_torch_parallel.py`` so that the compiles and the two-process
runs land on different test workers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pips_tpu.models import Pips as JaxPips
from pips_tpu.parallel import make_mesh, make_sharded_train_step, replicate, shard_batch
from pips_tpu.train import optim as joptim
from pips_tpu.train.step import TrainState
from pips_tpu_torch import Pips
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params
from test_torch_parallel import _run_two
from test_torch_train import METRIC_RTOL, TINY, _leaves, _params, assert_grads_match

LR, STEPS = 1e-3, 100  # the first step's rate is LR / 25 (OneCycle's start)


def _batch(grad_acc: int) -> dict:
    rng = np.random.RandomState(7)
    B, S, N, H, W = 2 * grad_acc, 4, 16, 64, 96
    b = {"rgbs": (rng.rand(B, S, H, W, 3) * 255).astype(np.float32),
         "trajs": (rng.rand(B, S, N, 2) * [W - 8, H - 8] + 4).astype(np.float32),
         "visibles": (rng.rand(B, S, N) > 0.3).astype(np.float32),
         "valids": (rng.rand(B, S, N) > 0.1).astype(np.float32)}
    if grad_acc > 1:
        b = {k: v.reshape(grad_acc, B // grad_acc, *v.shape[1:]) for k, v in b.items()}
    return b


def _record_grads() -> optax.GradientTransformation:
    """Passes the grads on and keeps them as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


@functools.lru_cache(maxsize=None)
def _jax_step(shape: tuple, grad_acc: int):
    """(metrics, grads, new params) of JAX's sharded step at mesh ``shape``."""
    model = JaxPips(**TINY)
    tx = optax.chain(_record_grads(), joptim.make_optimizer(LR, STEPS))
    mesh = make_mesh(shape)
    state = jax.device_put(TrainState.create(apply_fn=model.apply, params=_params(), tx=tx),
                           replicate(mesh))
    step = make_sharded_train_step(model, tx, mesh, iters=1, horz_flip=True, vert_flip=False,
                                   grad_acc=grad_acc, donate_state=False)
    new, metrics = step(state, shard_batch(mesh, _batch(grad_acc), grad_acc))
    return ({k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, new.opt_state[0]),
            jax.tree.map(np.asarray, new.params))


@pytest.mark.parametrize("shape,grad_acc", [((2, 1), 1), ((1, 2), 1), ((2, 1), 2)],
                         ids=["mesh 2x1", "mesh 1x2", "mesh 2x1 grad_acc 2"])
def test_sharded_step_equals_jax_sharded_step(tmp_path, shape, grad_acc):
    jmetrics, jgrads, jparams = _jax_step(shape, grad_acc)
    torch.save(load_flax_params(Pips(**TINY), _params()).state_dict(), tmp_path / "init.pt")
    np.savez(tmp_path / "batch.npz", **_batch(grad_acc))
    ranks = _run_two("files", f"{tmp_path}|{shape[0]},{shape[1]}|{grad_acc}")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    metrics = ranks[0]["metrics"]
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    assert metrics["ce"] > 0 and metrics["vis"] > 0
    out = torch.load(tmp_path / "out.pt")
    assert_grads_match(_leaves(jgrads), _leaves(flax_from_state_dict(out["grads"])),
                       elementwise=2e-4, encoder_rel_l2=1e-2, encoder_cos=0.9999, zero=1e-5)
    want, got = _leaves(jparams), _leaves(flax_from_state_dict(out["params"]))
    assert sorted(want) == sorted(got)
    lr0 = LR / 25
    moved = 0
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        assert d.max() <= 2 * lr0 * (1 + 1e-3), (k, d.max())
        moved += int((d > 1e-6).sum())
    total = sum(v.size for v in want.values())
    assert moved <= 0.01 * total, (moved, total)
