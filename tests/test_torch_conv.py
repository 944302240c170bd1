"""The port's 3x3 conv (``kernels/conv_cuda.py``) and the ``fuse_conv3`` path
against the JAX package's ``conv3x3_same`` and ``Pips(fuse_conv3=True)``.

JAX runs its Pallas kernel in interpret mode (``conv_pallas.interpret_mode``,
as ``tests/test_conv_kernel.py`` does); the port, on CPU tensors, runs the
plain version with the same backward structure (dx by the rotated weights,
dW by the library's weight-grad conv). The JAX layout is NHWC/HWIO, the
port's NCHW/OIHW; the inputs are the same numpy arrays, transposed. Bounds:

* forward, at ``test_conv_kernel.py``'s shapes and tolerances: f32 1e-5,
  bf16 3e-2, and H=6 (the JAX kernel's odd row tile) at 1e-5;
* f32 grads of x, w and b: 2e-4 (``test_conv_kernel.py``'s bound);
* bf16 grads, with the f32 parameters cast to bf16 as the encoder does:
  JAX's ``_bwd`` casts dW and db to the kernel weight's dtype (bf16), so the
  f32 weight's gradient holds bf16 values and the f32 bias's comes back as a
  bf16 array; the port returns f32 grads that hold the same bf16 values.
  Both sides sum exact bf16 products in f32 in different orders and round
  once, and dy itself is the cotangent of a bf16 output; so each grad is held
  to 4 bf16 ulps at its largest magnitude (measured: dW 0.03 of one, dx
  1e-6 of one, db equal);
* the encoder with ``fuse_conv3`` (f32): outputs 1e-4, as
  ``tests/test_torch_encoder.py``; parameter grads by the encoder rule of
  ``tests/test_torch_train.py`` (each leaf within 1e-2 relative L2 and a
  cosine of 0.9999; zero-gradient biases below 1e-5 of the largest grad),
  since relu masks flip where two f32 forwards differ by 1e-5;
* a TINY ``Pips(fuse_conv3=True)`` window, one iteration: f32 as
  ``tests/test_torch_pips.py`` holds it (2e-3 px, visibility 1e-3); bf16 with
  fused channel blocks within that file's bf16 bounds (max 1 px, median
  0.2 px, visibility 0.25).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.kernels import conv_pallas
from pips_tpu.models import BasicEncoder as JaxEncoder
from pips_tpu.models import Pips as JaxPips
from pips_tpu_torch import Pips, make_pips
from pips_tpu_torch.convert import flax_from_state_dict, load_flax_params
from pips_tpu_torch.kernels import conv_cuda
from pips_tpu_torch.kernels.conv_cuda import conv3x3_reference, conv3x3_same
from pips_tpu_torch.models import encoder as encoder_module
from pips_tpu_torch.models.encoder import BasicEncoder

TINY = dict(S=8, stride=8, latent_dim=16, mixer_dim=32, mixer_depth=2)
ENC = dict(output_dim=16, stride=8, stage_dims=(64, 12, 16, 16))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker, as tests/test_torch_train.py does.
    (With 8 threads, this torch build's CPU conv backward at the 12-channel
    stage of ``ENC`` aborts the process with a double free.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(B=2, H=8, W=16, C=64, O=64, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    w = (rng.randn(3, 3, C, O) * 0.1).astype(np.float32)
    b = (rng.randn(O) * 0.1).astype(np.float32)
    return x, w, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _ulp(a) -> float:
    return 2.0 ** (np.ceil(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "odd_height"])
def test_forward_matches_jax_kernel(case):
    x, w, b = _args(H=6, seed=1) if case == "odd_height" else _args()
    if case == "odd_height":
        b = np.zeros_like(b)
    dt = "bfloat16" if case == "bfloat16" else "float32"
    with conv_pallas.interpret_mode():
        want = np.asarray(conv_pallas.conv3x3_same(jnp.asarray(x).astype(dt), jnp.asarray(w),
                                                   jnp.asarray(b)), np.float32)
    got = conv3x3_same(_nchw(x).to(getattr(torch, dt)), _oihw(w), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dt) and got.shape == (x.shape[0], 64, *x.shape[1:3])
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = 3e-2 if dt == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert conv_cuda.launches == 0  # CPU tensors run the plain version


def _jax_grads(x, w, b, dt):
    def loss(x, w, b):
        y = conv_pallas.conv3x3_same(x.astype(dt), w.astype(dt), b)
        return jnp.sum(jnp.square(y.astype(jnp.float32))) * 1e-2

    with conv_pallas.interpret_mode():
        return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax_custom_vjp(dtype):
    x, w, b = _args(seed=2)
    gx, gw, gb = _jax_grads(x, w, b, dtype)
    td = getattr(torch, dtype)
    xt = _nchw(x).to(td).requires_grad_(True)
    wt, bt = _oihw(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y = conv3x3_same(xt, wt.to(td), bt)  # the encoder's cast of its f32 weight
    (y.float().square().sum() * 1e-2).backward()
    assert xt.grad.dtype == td and wt.grad.dtype == bt.grad.dtype == torch.float32
    # JAX: dW through the cast is f32, db is the custom VJP's own bf16 cotangent
    assert np.asarray(gw).dtype == np.float32 and np.asarray(gb).dtype == np.dtype(dtype)
    pairs = {"x": (xt.grad.float().permute(0, 2, 3, 1), gx),
             "w": (wt.grad.permute(2, 3, 1, 0), gw), "b": (bt.grad, gb)}
    for name, (got, want) in pairs.items():
        got, want = got.numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            if name != "x":  # the f32 parameters' grads hold bf16 values, as JAX's do
                assert np.array_equal(torch.from_numpy(got).bfloat16().float().numpy(), got), name
            err = np.abs(got - want).max()
            assert err <= 4 * _ulp(want), (name, err, _ulp(want))


def test_fuse_conv3_flags_keep_the_state_dict():
    """``make_pips(fuse_conv3=True, full_s2d=...)`` is accepted, as in JAX, and
    the parameters are the same in every mode, names, shapes and values."""
    tiny = dict(latent_dim=16, mixer_dim=32, mixer_depth=1)
    base = make_pips(device="cpu", seed=3, **tiny).state_dict()
    for kw in (dict(fuse_conv3=True), dict(fuse_conv3=True, full_s2d=False),
               dict(full_s2d=False)):
        sd = make_pips(device="cpu", seed=3, **tiny, **kw).state_dict()
        assert list(sd) == list(base)
        for k in base:
            assert torch.equal(sd[k], base[k]), (kw, k)


@pytest.mark.parametrize("width,routed", [(96, 4), (98, 0)])
def test_fuse_conv3_routes_the_four_stage1_convs(monkeypatch, width, routed):
    """JAX's eligibility (3x3, stride 1, pad 1, 64 -> 64, even W) picks the
    four stage-1 convs of the flagship encoder, and none when stage 1 has an
    odd width."""
    calls = []

    def counting(x, w, b):
        calls.append(tuple(x.shape))
        return conv3x3_same(x, w, b)

    monkeypatch.setattr(encoder_module, "conv3x3_same", counting)
    model = Pips(**TINY, fuse_conv3=True).eval()
    with torch.no_grad():
        model.encode(torch.zeros(1, 8, 64, width, 3))
    assert len(calls) == routed and all(s == (8, 64, 32, width // 2) for s in calls)


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    frames = (np.random.RandomState(4).rand(2, 32, 48, 3) * 2 - 1).astype(np.float32)
    jm = JaxEncoder(**ENC, fuse_conv3=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.asarray(frames))
    rng = np.random.RandomState(5)  # non-zero biases, so a mis-mapped leaf shows
    params = jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                          params)

    def loss(p, x):
        y = jm.apply(p, x)
        return jnp.sum(jnp.square(y)) * 1e-2, y

    with conv_pallas.interpret_mode():
        (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params,
                                                                        jnp.asarray(frames))
    return frames, params, np.asarray(y), jax.tree.map(np.asarray, grads)


def test_encoder_fuse_conv3_matches_jax_forward_and_grads():
    frames, params, want, jgrads = _jax_encoder()
    tm = load_flax_params(BasicEncoder(**ENC, fuse_conv3=True), params)
    y = tm(torch.from_numpy(frames).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (y.square().sum() * 1e-2).backward()
    got = flax_from_state_dict({k: p.grad for k, p in tm.named_parameters()})["params"]
    want_leaves = {jax.tree_util.keystr(k): v
                   for k, v in jax.tree_util.tree_flatten_with_path(jgrads["params"])[0]}
    got_leaves = {jax.tree_util.keystr(k): v
                  for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(want_leaves) == sorted(got_leaves)
    gmax = max(np.abs(v).max() for v in want_leaves.values())
    for k, w in want_leaves.items():
        w, g = w.astype(np.float64), got_leaves[k].astype(np.float64)
        if np.abs(w).max() <= 1e-5 * gmax:  # conv biases that feed an instance norm
            assert k.endswith("['bias']") and np.abs(g).max() <= 1e-5 * gmax, k
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        cos = np.dot(g.ravel(), w.ravel()) / (np.linalg.norm(g) * np.linalg.norm(w))
        assert rel <= 1e-2 and cos >= 0.9999, (k, rel, cos)


def _window_inputs():
    rng = np.random.RandomState(0)
    rgbs = (rng.rand(1, 8, 64, 96, 3) * 255).astype(np.float32)
    xys = (rng.rand(1, 12, 2) * [80, 48] + 8).astype(np.float32)
    return xys, rgbs


@functools.lru_cache(maxsize=None)
def _jax_window(bf16: bool):
    kw = dict(dtype=jnp.bfloat16, fuse_chanff=True) if bf16 else {}
    m = JaxPips(**TINY, fuse_conv3=True, **kw)
    xys, rgbs = _window_inputs()
    params = jax.jit(lambda k: m.init(k, jnp.asarray(xys), jnp.asarray(rgbs), iters=1))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: np.asarray(a + 0.02 * rng.randn(*a.shape).astype(np.float32)),
                          params)
    with pltpu.force_tpu_interpret_mode(), conv_pallas.interpret_mode():
        out = jax.jit(lambda p, x, r: m.apply(p, x, r, iters=1, corr_mode="onehot"))(
            params, jnp.asarray(xys), jnp.asarray(rgbs))
    return params, np.asarray(out.coord_predictions[-1]), np.asarray(out.vis_e, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pips_fuse_conv3_window_matches_jax(dtype):
    bf16 = dtype == "bfloat16"
    params, jtrajs, jvis = _jax_window(bf16)
    kw = dict(dtype=torch.bfloat16, fuse_chanff=True) if bf16 else {}
    tm = load_flax_params(Pips(**TINY, fuse_conv3=True, **kw), params).eval()
    xys, rgbs = _window_inputs()
    with torch.no_grad():
        o = tm(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=1, corr_mode="onehot")
    trajs, vis = o.coord_predictions[-1].numpy(), o.vis_e.float().numpy()
    np.testing.assert_array_equal(trajs[:, 0], xys)
    d = np.abs(trajs - jtrajs)
    if bf16:
        assert d.max() < 1.0 and np.median(d) < 0.2, (d.max(), np.median(d))
        assert np.abs(vis - jvis).max() < 0.25
    else:
        assert d.max() <= 2e-3, d.max()
        np.testing.assert_allclose(vis, jvis, rtol=0, atol=1e-3)
