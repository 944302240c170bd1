"""The port's training step against the JAX package's, in f32 at TINY size.

The same weights (JAX init, perturbed so no leaf is trivial) and the same
synthetic batch go through ``jax.value_and_grad(train_loss_fn)`` and the
port's ``train_loss_fn`` + ``backward()``; every parameter's grad comes back
through ``convert.flax_from_state_dict`` and is compared leaf by leaf. One
iteration with the horizontal flip: coords are detached at the iteration
start, so nothing iterates through floor() and the forwards differ by f32
summation order only (the encoder's feature maps by ~2e-5 of their
magnitude). Bounds:

* loss and metrics: 1e-5 relative (measured <= 2e-6);
* grads outside the encoder: each leaf within 2e-4 of its largest magnitude
  (measured <= 4.6e-5);
* encoder grads: each leaf within 1e-2 relative L2 error and a cosine of at
  least 0.9999 (measured <= 3.0e-3 and >= 0.999995). The 13 relu'd conv
  layers turn a ~1e-5 forward difference into flipped relu masks at a few
  positions, and each flip moves a weight grad by a whole term: the port
  alone moves its own encoder weight grads by up to 6% (max elementwise)
  when the frames are perturbed by 1e-6 relative. Elementwise bounds would
  hold that noise, not the port, to account;
* leaves whose true gradient is exactly zero (conv biases that feed an
  instance norm, token-mixer fc2 biases that feed a LayerNorm over the other
  axis): both sides below 1e-5 of the model's largest grad, the cancellation
  noise they leave (measured <= 3e-6);
* the optimizer: one clipped and one unclipped AdamW step from the same
  grads against optax's ``make_optimizer`` chain, 1e-6 relative on the new
  parameters; the rate equals ``onecycle_linear`` at every step;
* gradient accumulation and remat are the port against itself: equal to the
  sum of the microbatch grads and to the plain step, 1e-6 relative.

The JAX grad compiles once per module (``lru_cache``); the bf16 fused step
has its own file, so the two costly compiles land on different workers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pips_tpu.models import Pips as JaxPips
from pips_tpu.train import optim as joptim
from pips_tpu.train import step as jstep
from pips_tpu_torch import Pips
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params
from pips_tpu_torch.data import SyntheticPointDataset
from pips_tpu_torch.train import (Optimizer, apply_flip_doubling, make_optimizer,
                                  make_train_step, onecycle_linear, train_loss_fn)

TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_chain.py does:
    the TINY model's CPU ops oversubscribe the cores among busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _batch(B: int = 1, seed: int = 3):
    ds = SyntheticPointDataset(S=4, N=8, H=64, W=96, seed=seed)
    samples = [ds[i][0] for i in range(B)]
    return {k: np.stack([s[k] for s in samples]).astype(np.float32) for k in samples[0]}


@functools.lru_cache(maxsize=None)
def _params():
    b = _batch()
    m = JaxPips(**TINY)
    params = jax.jit(lambda k: m.init(k, jnp.asarray(b["trajs"][:, 0]), jnp.asarray(b["rgbs"]),
                                      iters=1))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    return jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                        params)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    m = JaxPips(**TINY)

    def loss(p, b):
        return jstep.train_loss_fn(m, p, jstep.apply_flip_doubling(b, True, False), 1)

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _params(), {k: jnp.asarray(v) for k, v in _batch().items()})
    return float(total), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray,
                                                                                  grads)


def _port_model(**kw) -> Pips:
    return load_flax_params(Pips(**TINY, **kw), _params()).train()


def _port_grads(model, batch, flips=(True, False), iters=1):
    model.zero_grad(set_to_none=True)
    b = apply_flip_doubling({k: torch.from_numpy(v) for k, v in batch.items()}, *flips)
    total, metrics = train_loss_fn(model, b, iters)
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_loss_and_every_grad_match_jax():
    total, jmetrics, jgrads = _jax_value_and_grad()
    metrics, grads = _port_grads(_port_model(), _batch())
    np.testing.assert_allclose(metrics["total_loss"], total, rtol=METRIC_RTOL)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=k)
    assert metrics["ce"] > 0 and metrics["vis"] > 0
    assert_grads_match(_leaves(jgrads), _leaves(flax_from_state_dict(grads)),
                       elementwise=2e-4, encoder_rel_l2=1e-2, encoder_cos=0.9999, zero=1e-5)


def assert_grads_match(want, got, elementwise, encoder_rel_l2, encoder_cos, zero):
    """The three classes of leaves of the module docstring."""
    assert sorted(want) == sorted(got)
    gmax = max(np.abs(w).max() for w in want.values())
    for k in want:
        w, g = want[k].astype(np.float64), got[k].astype(np.float64)
        assert g.shape == w.shape, k
        if np.abs(w).max() <= zero * gmax:
            assert k.endswith("['bias']"), k  # only biases can have a zero gradient here
            assert np.abs(g).max() <= zero * gmax, (k, np.abs(g).max(), gmax)
        elif "['fnet']" in k:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            cos = np.dot(g.ravel(), w.ravel()) / (np.linalg.norm(g) * np.linalg.norm(w))
            assert rel <= encoder_rel_l2 and cos >= encoder_cos, (k, rel, cos)
        else:
            err = np.abs(g - w).max()
            assert err <= elementwise * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("scale", [1.0, 1e-3])  # clipped (|g| > 5), then not clipped
def test_optimizer_step_matches_optax(scale):
    _, _, jgrads = _jax_value_and_grad()
    jgrads = jax.tree.map(lambda g: g * np.float32(scale), jgrads)
    norm = float(optax.global_norm(jgrads))
    assert (norm > 5.0) == (scale == 1.0), norm
    tx = joptim.make_optimizer(1e-3, 40)
    params = jax.tree.map(jnp.asarray, _params())
    state = tx.init(params)

    @jax.jit
    def jax_step(g, st, p):
        updates, st = tx.update(g, st, p)
        return optax.apply_updates(p, updates), st

    model = _port_model()
    opt = make_optimizer(model.parameters(), 1e-3, 40)
    named = dict(model.named_parameters())
    grads_sd = {k: torch.from_numpy(np.array(v))
                for k, v in _state_dict_from_tree(jgrads).items()}
    for _ in range(2):  # the second step reads the schedule's next rate and Adam's moments
        params, state = jax_step(jgrads, state, params)
        opt.zero_grad()
        for k, p in named.items():
            p.grad = grads_sd[k].clone()
        got_norm = opt.step()
        np.testing.assert_allclose(got_norm, norm, rtol=1e-6)
    want = _leaves(params)
    got = _leaves(flax_from_state_dict(model.state_dict()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def _state_dict_from_tree(tree):
    from pips_tpu_torch.convert import state_dict_from_flax

    return state_dict_from_flax(tree)


def test_lr_schedule_equals_onecycle_linear_every_step():
    T = 130  # make_optimizer(num_steps=30) -> onecycle over 30 + 100 steps
    want = np.asarray(joptim.onecycle_linear(1e-3, T)(jnp.arange(T + 5)))  # f32, per step
    sched = onecycle_linear(1e-3, T)
    for s in range(T + 5):
        assert sched(s) == float(want[s]), s
    model = _port_model()
    opt = make_optimizer(model.parameters(), 1e-3, 30)
    assert isinstance(opt, Optimizer)
    for s in range(12):  # through the warm-up (7 steps) and into the decay
        assert opt.lr == float(want[s]), s
        opt.zero_grad()
        for p in opt.params:
            p.grad = torch.zeros_like(p)
        opt.step()


class _Recorder:
    """Optimizer stand-in that keeps the grads it is asked to apply."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self):
        self.grads = {n: p.grad.clone() for n, p in self.model.named_parameters()}


def test_grad_acc_sums_microbatch_grads_and_averages_metrics():
    batch = _batch(B=2)
    model = _port_model()
    per = [_port_grads(model, {k: v[i:i + 1] for k, v in batch.items()}, flips=(False, False))
           for i in range(2)]
    rec = _Recorder(model)
    step = make_train_step(model, rec, iters=1, horz_flip=False, vert_flip=False, grad_acc=2)
    metrics = step({k: v.reshape(2, 1, *v.shape[1:]) for k, v in batch.items()})
    for n, g in rec.grads.items():
        np.testing.assert_allclose(g.numpy(), (per[0][1][n] + per[1][1][n]).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    for k, v in metrics.items():
        assert isinstance(v, float)
        np.testing.assert_allclose(v, (per[0][0][k] + per[1][0][k]) / 2, rtol=1e-6, err_msg=k)
    assert abs(per[0][0]["total_loss"] - per[1][0]["total_loss"]) > 1e-3  # they differ


def test_remat_equals_plain_step():
    batch = _batch()
    want_m, want = _port_grads(_port_model(), batch)
    model = _port_model(remat_mixer=True, remat_corr=True, remat_encoder=True)
    rec = _Recorder(model)
    metrics = make_train_step(model, rec, iters=1, horz_flip=True, vert_flip=False,
                              remat=True)(batch)
    for k in want_m:
        np.testing.assert_allclose(metrics[k], want_m[k], rtol=1e-6, err_msg=k)
    for n, g in rec.grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)


def test_train_steps_reduce_the_loss():
    """The synthetic batch, two flips (B*4), two iterations: eight steps of the
    port's step lower the loss, as tests/test_train.py asks of the JAX step."""
    model = _port_model()
    opt = make_optimizer(model.parameters(), 3e-4, 8)
    step = make_train_step(model, opt, iters=2, horz_flip=True, vert_flip=True)
    losses = [step(_batch())["total_loss"] for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_make_train_step_takes_jax_argument_order(monkeypatch):
    """``make_train_step`` takes JAX's arguments in JAX's order after the
    model and the optimizer (..., grad_acc, use_fused_corr, remat), the
    port's own ``sync_metrics`` after them; at TINY dims the positional call
    ``(model, opt, 1, True, False, 1, True)`` trains through the fused corr
    path without remat, as the keyword call does, to the same loss bits."""
    import inspect

    from pips_tpu_torch.train import step as tstep

    jnames = list(inspect.signature(jstep.make_train_step).parameters)
    tnames = list(inspect.signature(make_train_step).parameters)
    assert jnames[:2] == ["model", "tx"] and tnames[:2] == ["model", "optimizer"]
    assert tnames[2:] == jnames[2:] + ["sync_metrics"]
    seen = []
    loss_fn, ckpt = tstep.train_loss_fn, tstep.checkpoint
    monkeypatch.setattr(tstep, "train_loss_fn", lambda *a, **kw: (
        seen.append(("fused", kw["use_fused_corr"])), loss_fn(*a, **kw))[1])
    monkeypatch.setattr(tstep, "checkpoint", lambda *a, **kw: (
        seen.append(("remat", True)), ckpt(*a, **kw))[1])
    batch = _batch()
    losses = []
    for args, kw in (((1, True, False, 1, True), {}),
                     ((), dict(iters=1, horz_flip=True, vert_flip=False, use_fused_corr=True))):
        model = _port_model()
        seen.clear()
        losses.append(make_train_step(model, _Recorder(model), *args, **kw)(batch)["total_loss"])
        assert seen == [("fused", True)]
    assert losses[0] == losses[1]
