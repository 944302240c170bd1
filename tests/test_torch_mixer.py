"""The port's mixer (models.mixer, kernels.mixer_cuda) against the JAX mixer.

``chan_ff_reference`` is the plain version the CUDA kernel is held to on the
card; here it is compared with the JAX fused kernel run in Pallas interpret
mode, as tests/test_mixer_kernel.py runs it. The JAX kernel keeps its
pre-activations in f32 where the JAX/port reference rounds them to x's dtype,
so bf16 differs by bf16 roundings (2e-2); f32 is tight (2e-5).

``chan_ff_bwd_reference``, the plain version of the backward kernel, follows
the JAX backward kernel's math and casts, so it is held to ``jax.vjp`` of the
JAX block (interpret mode) tightly: each grad within BWD_TOL of the largest
magnitude of that grad. In f32 the two differ by summation order and by the
rational erf the JAX kernel uses (measured <= 8.4e-7 of the magnitude); in
bf16 also by an occasional one-ulp flip of a rounded operand (f32 grads
measured <= 5.3e-4); a bf16 dx is held to two bf16 ulps at its largest
magnitude (measured one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.kernels.mixer_pallas import chan_ff_block as jax_chan_ff_block
from pips_tpu.models import mixer as jmixer
from pips_tpu_torch.convert import state_dict_from_flax
from pips_tpu_torch.kernels import mixer_cuda
from pips_tpu_torch.models import mixer

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _block_args(R, D=64, F=256, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(R, D), 1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D),
            rng.randn(D, F) / np.sqrt(D), 0.1 * rng.randn(F),
            rng.randn(F, D) / np.sqrt(F), 0.1 * rng.randn(D)]


def _torch_args(a, dtype):
    x, s, b, w1, b1, w2, b2 = (torch.from_numpy(np.asarray(v, np.float32)) for v in a)
    return x.to(dtype), s, b, w1.to(dtype), b1, w2.to(dtype), b2


@pytest.mark.parametrize("R", [256, 200])  # aligned and ragged rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_ff_reference_matches_jax_kernel(R, dtype):
    a = _block_args(R)
    ja = [jnp.asarray(v, jnp.float32) for v in a]
    ja[0] = ja[0].astype(getattr(jnp, dtype))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_chan_ff_block(*ja), np.float32)
    ta = _torch_args(a, getattr(torch, dtype))
    got = mixer_cuda.chan_ff_reference(*ta)
    assert got.dtype == ta[0].dtype and got.shape == (R, 64)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_chan_ff_block_on_cpu_is_the_plain_version(monkeypatch):
    ta = _torch_args(_block_args(40), torch.bfloat16)
    calls = []

    def spy(*args):
        calls.append(args)
        return args[0]

    monkeypatch.setattr(mixer_cuda, "chan_ff_reference", spy)
    monkeypatch.setattr(mixer_cuda, "_kernel", lambda: pytest.fail("built a CUDA kernel"))
    before = mixer_cuda.launches
    assert mixer_cuda.chan_ff_block(*ta) is ta[0]
    assert len(calls) == 1 and mixer_cuda.launches == before


@pytest.mark.parametrize("bad", ["w1_dtype", "b1_shape", "x_rank"])
def test_chan_ff_block_rejects_bad_inputs(bad):
    x, s, b, w1, b1, w2, b2 = _torch_args(_block_args(32), torch.bfloat16)
    if bad == "w1_dtype":  # weights come in x's dtype or f32 (cast inside), nothing else
        w1 = w1.half()
    elif bad == "b1_shape":
        b1 = b1[:-1]
    else:
        x = x[None]
    with pytest.raises(ValueError):
        mixer_cuda.chan_ff_block(x, s, b, w1, b1, w2, b2)


def _flax_mixer(fuse, dtype, S=8, input_dim=40, dim=32, depth=2, out=24, seed=0):
    kw = dict(S=S, input_dim=input_dim, dim=dim, output_dim=out, depth=depth,
              dtype=getattr(jnp, dtype) if dtype != "float32" else None, fuse_chanff=fuse)
    m = jmixer.MLPMixer(**kw)
    x = jnp.zeros((4, S, input_dim))
    params = jax.jit(m.init)(jax.random.PRNGKey(seed), x)
    # non-trivial LN and bias values, so a wrong mapping cannot hide
    rng = np.random.RandomState(seed + 1)
    params = jax.tree.map(lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    return m, params


@pytest.mark.parametrize("fuse,dtype", [(False, "float32"), (True, "float32"),
                                        (False, "bfloat16"), (True, "bfloat16")])
def test_mlp_mixer_matches_jax(fuse, dtype):
    m, params = _flax_mixer(fuse, dtype)
    rng = np.random.RandomState(3)
    parts = [rng.randn(4, 8, 16), rng.randn(4, 8, 24)]  # split embed matmul
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(m.apply(params, tuple(jnp.asarray(p, jnp.float32) for p in parts)),
                          np.float32)
    tm = mixer.MLPMixer(8, 40, 32, 24, 2, dtype=getattr(torch, dtype) if dtype != "float32"
                        else None, fuse_chanff=fuse)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        state_dict_from_flax(params).items()}, strict=True)
    with torch.no_grad():
        got = tm(tuple(torch.from_numpy(p.astype(np.float32)) for p in parts)).float().numpy()
    tol = TOL["float32"] if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("fuse", [False, True])
def test_delta_block_matches_jax(fuse):
    kw = dict(latent_dim=16, corr_levels=2, corr_radius=2, S=8, mixer_dim=32, mixer_depth=2)
    jm = jmixer.DeltaBlock(**kw, fuse_chanff=fuse)
    rng = np.random.RandomState(5)
    fhid, fcorr = rng.randn(6, 8, 16), rng.randn(6, 8, 2 * 25)
    flow = np.concatenate([rng.randn(6, 8, 2) * 3,
                           np.broadcast_to(np.linspace(0, 8, 8)[None, :, None], (6, 8, 1))], -1)
    ins = [jnp.asarray(v, jnp.float32) for v in (fhid, fcorr, flow)]
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), *ins)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply(params, *ins))
    tm = mixer.DeltaBlock(**kw, fuse_chanff=fuse)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        state_dict_from_flax(params).items()}, strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(v.astype(np.float32)) for v in (fhid, fcorr, flow)))
    assert got.shape == (6, 8, 18)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-3}  # of each grad's largest magnitude
GRAD_NAMES = ("dx", "d ln_scale", "d ln_bias", "dw1", "db1", "dw2", "db2")


def _assert_grads_close(got, want, rel, tag, bf16_dx=False):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (tag, name, g.shape, w.shape)
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        tol = 2.0 ** (np.ceil(np.log2(scale)) - 7) if (bf16_dx and name == "dx") else rel * scale
        assert err <= tol, (tag, name, err, scale)


@pytest.mark.parametrize("R", [256, 200])  # aligned and ragged rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_ff_bwd_reference_matches_jax_vjp(R, dtype):
    a = _block_args(R, seed=R)
    dy = np.random.RandomState(R + 1).randn(R, 64)
    cd = getattr(jnp, dtype)
    ja = [jnp.asarray(v, jnp.float32) for v in a]
    ja[0] = ja[0].astype(cd)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_chan_ff_block, *ja)
        want = vjp(jnp.asarray(dy, jnp.float32).astype(cd))
    ta = _torch_args(a, getattr(torch, dtype))
    x, s, b, w1, b1, w2, _ = ta
    got = mixer_cuda.chan_ff_bwd_reference(x, torch.from_numpy(dy.astype(np.float32)).to(x.dtype),
                                           s, b, w1, b1, w2)
    assert got[0].dtype == x.dtype and all(g.dtype == torch.float32 for g in got[1:])
    _assert_grads_close([g.float().numpy() for g in got], [want[0].astype(jnp.float32),
                                                            *want[1:]], BWD_TOL[dtype],
                        f"{dtype} R={R}", bf16_dx=dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_ff_block_cpu_grads_are_the_plain_backward(dtype):
    """Autograd through ``chan_ff_block`` on CPU tensors runs the plain
    backward, bit for bit, and keeps f32 weight grads for f32 weights."""
    a = _block_args(72, seed=5)
    dtp = getattr(torch, dtype)
    x, s, b, w1, b1, w2, b2 = (torch.from_numpy(np.asarray(v, np.float32)) for v in a)
    x = x.to(dtp)
    leaves = [t.clone().requires_grad_(True) for t in (x, s, b, w1, b1, w2, b2)]
    dy = torch.from_numpy(np.random.RandomState(6).randn(72, 64).astype(np.float32)).to(dtp)
    y = mixer_cuda.chan_ff_block(*leaves)
    y.backward(dy)
    want = mixer_cuda.chan_ff_bwd_reference(x, dy, s, b, w1.to(dtp), b1, w2.to(dtp))
    assert leaves[3].grad.dtype == torch.float32
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        np.testing.assert_array_equal(leaf.grad.float().numpy(), w.float().numpy(), err_msg=name)
    with torch.no_grad():
        np.testing.assert_array_equal(
            y.detach().float().numpy(),
            mixer_cuda.chan_ff_reference(x, s, b, w1.to(dtp), b1, w2.to(dtp), b2).float().numpy())


def test_fused_f32_mlp_mixer_grads_match_jax():
    """``fuse_chanff=True`` in f32 (the path of the f32 backward kernel): the
    grads of every parameter and of both inputs against ``jax.grad`` of JAX's
    fused f32 mixer, whose channel blocks run the Pallas custom VJP in
    interpret mode, at ``_flax_mixer``'s dims. Each within ``BWD_TOL``'s f32
    1e-5 of its largest magnitude (summation order and XLA's rational erf);
    a token block's fc2 bias, whose grad the next LayerNorm makes zero in
    exact math, is rounding noise and held to 1e-5 of the largest grad."""
    m, params = _flax_mixer(True, "float32")
    rng = np.random.RandomState(7)
    parts = [rng.randn(4, 8, 16), rng.randn(4, 8, 24)]
    jparts = tuple(jnp.asarray(p, jnp.float32) for p in parts)
    with pltpu.force_tpu_interpret_mode():
        out = m.apply(params, jparts)
        cot = jnp.asarray(rng.randn(*out.shape), jnp.float32)
        pgrads, xgrads = jax.grad(lambda p, x: jnp.sum(m.apply(p, x) * cot), argnums=(0, 1))(
            params, jparts)
    want = state_dict_from_flax(pgrads)
    tm = mixer.MLPMixer(8, 40, 32, 24, 2, dtype=None, fuse_chanff=True)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_flax(params).items()},
                       strict=True)
    tparts = tuple(torch.from_numpy(p.astype(np.float32)).requires_grad_(True) for p in parts)
    (tm(tparts) * torch.from_numpy(np.array(cot))).sum().backward()
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    pairs = [(k, got[k], want[k]) for k in sorted(want)]
    pairs += [(f"input {i}", t.grad, np.asarray(g)) for i, (t, g) in enumerate(zip(tparts, xgrads))]
    top = max(np.abs(w).max() for _, _, w in pairs)
    for name, g, w in pairs:
        assert g is not None and g.dtype == torch.float32, name
        err = np.abs(g.numpy() - w).max()
        scale = top if name.endswith("_token.fc2.bias") else np.abs(w).max()
        assert err <= BWD_TOL["float32"] * scale, (name, err, scale)
