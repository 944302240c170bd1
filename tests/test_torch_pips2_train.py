"""One Pips2 (PIPs++) training step of the port against the JAX package's, in
f32 at TINY size (refiner 32 x 2, latent 16, 3 corr levels), its own file so
that its JAX compiles land on another worker than tests/test_torch_pips2.py's.

The same weights (JAX init at S=4, perturbed) and the same synthetic batch
(S=4, N=8 at 64x96, the horizontal flip) go through
``jax.value_and_grad(train_loss_fn)`` and the port's ``train_loss_fn`` +
``backward()`` at one iteration; PIPs++ has no CE term, so ``ce`` is 0 on both
sides. Two configurations: the plain channel block with the default ``full``
corr, and the fused channel block (the custom VJP: JAX's Pallas kernel in
interpret mode, the port's plain backward on CPU tensors) with
``use_fused_corr``. The bounds are those of tests/test_torch_train.py, where
the forwards differ by f32 summation order only: metrics 1e-5 relative; each
grad outside the encoder within 2e-4 of its largest magnitude; encoder leaves
within 1e-2 relative L2 and a cosine of at least 0.9999 (flipped relu masks);
leaves whose true gradient is zero below 1e-5 of the largest grad.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import assert_grads_match

from pips_tpu.models import Pips2 as JaxPips2
from pips_tpu.train import step as jstep
from pips_tpu_torch import Pips2
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params
from pips_tpu_torch.data import SyntheticPointDataset
from pips_tpu_torch.train import apply_flip_doubling, train_loss_fn

TINY = dict(stride=8, latent_dim=16, corr_levels=3, corr_radius=2, refiner_dim=32,
            refiner_depth=2)
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_train.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _batch():
    ds = SyntheticPointDataset(S=4, N=8, H=64, W=96, seed=3)
    sample = ds[0][0]
    return {k: np.asarray(v, np.float32)[None] for k, v in sample.items()}


@functools.lru_cache(maxsize=None)
def _params(fuse: bool):
    b = _batch()
    m = JaxPips2(**TINY, fuse_chanff=fuse)
    params = jax.jit(lambda k: m.init(k, jnp.asarray(b["trajs"][:, 0]), jnp.asarray(b["rgbs"]),
                                      iters=1))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    return jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                        params)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(fuse: bool, fused_corr: bool):
    from jax.experimental.pallas import tpu as pltpu

    m = JaxPips2(**TINY, fuse_chanff=fuse)

    def loss(p, b):
        return jstep.train_loss_fn(m, p, jstep.apply_flip_doubling(b, True, False), 1,
                                   use_fused_corr=fused_corr)

    with pltpu.force_tpu_interpret_mode():
        (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _params(fuse), {k: jnp.asarray(v) for k, v in _batch().items()})
    return float(total), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray,
                                                                                  grads)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fuse,fused_corr", [(False, False), (True, True)])
def test_pips2_train_loss_and_every_grad_match_jax(fuse, fused_corr):
    total, jmetrics, jgrads = _jax_value_and_grad(fuse, fused_corr)
    model = load_flax_params(Pips2(**TINY, fuse_chanff=fuse), _params(fuse)).train()
    b = apply_flip_doubling({k: torch.from_numpy(v) for k, v in _batch().items()}, True, False)
    loss, metrics = train_loss_fn(model, b, 1, use_fused_corr=fused_corr)
    loss.backward()
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(metrics["total_loss"], total, rtol=METRIC_RTOL)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=k)
    assert metrics["ce"] == 0.0 and jmetrics["ce"] == 0.0  # PIPs++ has no score-map CE
    assert metrics["seq"] > 0 and metrics["vis"] > 0
    assert all(g is not None for g in grads.values())
    assert_grads_match(_leaves(jgrads), _leaves(flax_from_state_dict(grads)),
                       elementwise=2e-4, encoder_rel_l2=1e-2, encoder_cos=0.9999, zero=1e-5)
