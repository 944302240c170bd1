"""The port's bf16 training step, with fused channel blocks, against the JAX
package's at TINY size.

Both run in bf16 with f32 parameters; JAX runs its Pallas channel-block
kernels (forward and the custom-VJP backward) in interpret mode, the port
their plain versions, which is what its autograd Function runs on the CPU.
bf16 rounds at other places in the two frameworks (the encoder's ~20 conv and
norm layers, the score volumes, the mixer). The encoder's grads are the
noisy ones: bf16 forwards flip relu masks, so both frameworks' bf16 encoder
grads sit ~30% (relative L2) from the f32 grads of the same weights, and as
far from each other. The bounds, each with its measured value:

* loss and metrics: 2e-2 relative (measured <= 3.4e-3);
* grads outside the encoder: relative L2 error <= 0.1 and cosine >= 0.995
  against JAX (measured <= 0.049 and >= 0.9992);
* encoder grads: relative L2 error <= 0.5 and cosine >= 0.85 against JAX
  (measured <= 0.33 and >= 0.945);
* every such leaf no further from the port's f32 grad (held to JAX's f32
  grad in test_torch_train.py) than 1.25 times JAX's bf16 grad is, plus 0.02
  (measured <= 1.034 times);
* leaves whose true gradient is zero (conv biases that feed an instance
  norm, token-mixer fc2 biases that feed a LayerNorm over the other axis):
  the port's below 1e-2 of the model's largest grad (measured <= 3.9e-3).
  JAX sums these bias grads in bf16 and leaves up to 0.31 of it there, so
  they are not compared with JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.models import Pips as JaxPips
from pips_tpu.train import step as jstep
from pips_tpu_torch import Pips
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params
from pips_tpu_torch.data import SyntheticPointDataset
from pips_tpu_torch.train import apply_flip_doubling, train_loss_fn

TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)
BF16 = dict(fuse_chanff=True)
METRIC_RTOL = 2e-2
MIXER = dict(rel_l2=0.1, cos=0.995)
ENCODER = dict(rel_l2=0.5, cos=0.85)
NO_WORSE = (1.25, 0.02)
ZERO = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_chain.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_grad_leaf(k: str) -> bool:
    """Biases followed by a normalisation that removes them."""
    return ((k.startswith("['params']['fnet']") and k.endswith("['bias']")
             and "['conv3']" not in k) or ("_token']['fc2']['bias']" in k))


@functools.lru_cache(maxsize=None)
def _batch():
    sample, _ = SyntheticPointDataset(S=4, N=8, H=64, W=96, seed=3)[0]
    return {k: v[None].astype(np.float32) for k, v in sample.items()}


@functools.lru_cache(maxsize=None)
def _jax_run():
    b = _batch()
    m = JaxPips(**TINY, dtype=jnp.bfloat16, **BF16)
    params = jax.jit(lambda k: m.init(k, jnp.asarray(b["trajs"][:, 0]), jnp.asarray(b["rgbs"]),
                                      iters=1))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                          params)

    def loss(p, bb):
        return jstep.train_loss_fn(m, p, jstep.apply_flip_doubling(bb, True, False), 1)

    with pltpu.force_tpu_interpret_mode():
        (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    return params, {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_cos(g, w):
    return (np.linalg.norm(g - w) / np.linalg.norm(w),
            np.dot(g.ravel(), w.ravel()) / (np.linalg.norm(g) * np.linalg.norm(w)))


def _port_grads(dtype, **kw):
    params = _jax_run()[0]
    model = load_flax_params(Pips(**TINY, dtype=dtype, **kw), params).train()
    b = apply_flip_doubling({k: torch.from_numpy(v) for k, v in _batch().items()}, True, False)
    total, metrics = train_loss_fn(model, b, 1)
    total.backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    return ({k: float(v.detach()) for k, v in metrics.items()},
            _leaves(flax_from_state_dict({n: p.grad for n, p in model.named_parameters()})))


def test_bf16_fused_train_step_matches_jax_interpret():
    _, jmetrics, jgrads = _jax_run()
    metrics, got = _port_grads(torch.bfloat16, **BF16)
    _, f32 = _port_grads(None)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=METRIC_RTOL, err_msg=k)
    want = _leaves(jgrads)
    assert sorted(want) == sorted(got)
    gmax = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        if _zero_grad_leaf(k):
            assert np.abs(g).max() <= ZERO * gmax, (k, np.abs(g).max(), gmax)
            continue
        rel, cos = _rel_cos(g, w)
        bound = ENCODER if "['fnet']" in k else MIXER
        assert rel <= bound["rel_l2"] and cos >= bound["cos"], (k, rel, cos)
        port_off, jax_off = _rel_cos(g, f32[k])[0], _rel_cos(w, f32[k])[0]
        assert port_off <= NO_WORSE[0] * jax_off + NO_WORSE[1], (k, port_off, jax_off)
