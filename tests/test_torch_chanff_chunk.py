"""The port's F-chunked channel block (``kernels/chanff_chunk_cuda.py``) and
its profiling tool against ``tools/profile_chanff_chunk.py``.

``chan_ff_chunked_reference`` and ``chan_ff_chunked_bwd_reference`` are the
plain versions the CUDA kernels of ``csrc/chanff_chunk.cu`` are held to on
the card; here they are held to JAX's ``make_chunked(fc)``, loaded from the
tool by file path and run in Pallas interpret mode, on the same numpy inputs.
R=100 pads to 128 rows in JAX; D=64 is narrow; F must be the tool's module
constant, 2048, because its kernels read it. Each (fc, dtype) compiles its
JAX forward and VJP once per module.

Bounds are ``tests/test_torch_mixer.py``'s: the forward within ``TOL``
(f32 2e-5: summation order and XLA's rational erf; bf16 2e-2 as there,
though both sides keep the products in f32 and round once); each grad within
``BWD_TOL`` of its largest magnitude, a bf16 dx within two bf16 ulps.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu_torch.kernels import chanff_chunk_cuda, mixer_cuda
from pips_tpu_torch.kernels.chanff_chunk_cuda import (chan_ff_block_chunked,
                                                      chan_ff_chunked_bwd_reference,
                                                      chan_ff_chunked_reference)
from pips_tpu_torch.tools import profile_chanff_chunk
from test_torch_mixer import BWD_TOL, GRAD_NAMES, TOL, _assert_grads_close

TOOL = Path(__file__).resolve().parents[1] / "tools" / "profile_chanff_chunk.py"
R, D, F = 100, 64, 2048


@functools.lru_cache(maxsize=None)
def _tool():
    """The JAX tool as a module, imported once (it draws 12 weight sets)."""
    spec = importlib.util.spec_from_file_location("jax_profile_chanff_chunk", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(R, D), 1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D),
            rng.randn(D, F) / np.sqrt(D), 0.1 * rng.randn(F),
            rng.randn(F, D) / np.sqrt(F), 0.1 * rng.randn(D)]


def _dy(seed=1):
    return np.random.RandomState(seed).randn(R, D)


def _torch_args(a, dtype):
    x, s, b, w1, b1, w2, b2 = (torch.from_numpy(np.asarray(v, np.float32)) for v in a)
    return x.to(dtype), s, b, w1.to(dtype), b1, w2.to(dtype), b2


@functools.lru_cache(maxsize=None)
def _jax_chunked(fc, dtype):
    """JAX's chunked block at (fc, dtype): its output and its VJP of ``_dy()``."""
    cd = getattr(jnp, dtype)
    ja = [jnp.asarray(v, jnp.float32) for v in _args()]
    ja[0] = ja[0].astype(cd)
    block = _tool().make_chunked(fc)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(block, *ja)
        grads = vjp(jnp.asarray(_dy(), jnp.float32).astype(cd))
    return (np.asarray(y.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fc", [512, 1024])
def test_chunked_reference_matches_jax_make_chunked(fc, dtype):
    want, _ = _jax_chunked(fc, dtype)
    ta = _torch_args(_args(), getattr(torch, dtype))
    got = chan_ff_chunked_reference(*ta, fc=fc)
    assert got.dtype == ta[0].dtype and got.shape == (R, D)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fc", [512, 1024])
def test_chunked_bwd_reference_matches_jax_vjp(fc, dtype):
    _, want = _jax_chunked(fc, dtype)
    x, s, b, w1, b1, w2, _ = _torch_args(_args(), getattr(torch, dtype))
    dy = torch.from_numpy(_dy().astype(np.float32)).to(x.dtype)
    got = chan_ff_chunked_bwd_reference(x, dy, s, b, w1, b1, w2, fc=fc)
    assert got[0].dtype == x.dtype and all(g.dtype == torch.float32 for g in got[1:])
    _assert_grads_close([g.float().numpy() for g in got], want, BWD_TOL[dtype],
                        f"{dtype} fc={fc}", bf16_dx=dtype == "bfloat16")


def test_chunked_block_on_cpu_is_the_plain_version(monkeypatch):
    """On CPU tensors the forward and the autograd backward are the plain
    versions, bit for bit; no kernel is built and no launch counted; f32
    weights keep f32 grads."""
    calls = []
    real = chanff_chunk_cuda.chan_ff_chunked_reference

    def spy(*a, **k):
        calls.append(k["fc"])
        return real(*a, **k)

    monkeypatch.setattr(chanff_chunk_cuda, "chan_ff_chunked_reference", spy)
    monkeypatch.setattr(chanff_chunk_cuda, "_kernel", lambda name: pytest.fail("built a kernel"))
    monkeypatch.setattr(mixer_cuda, "_kernel", lambda name: pytest.fail("built a kernel"))
    before = (chanff_chunk_cuda.launches, chanff_chunk_cuda.bwd_launches)
    a = _args(seed=3)
    x = torch.from_numpy(a[0].astype(np.float32)).to(torch.bfloat16)
    leaves = [torch.from_numpy(v.astype(np.float32)).requires_grad_(True) for v in a[1:]]
    y = chan_ff_block_chunked(x, *leaves, fc=256)
    dy = torch.from_numpy(_dy(seed=4).astype(np.float32)).to(torch.bfloat16)
    y.backward(dy)
    assert calls == [256]
    assert (chanff_chunk_cuda.launches, chanff_chunk_cuda.bwd_launches) == before
    s, b, w1, b1, w2, b2 = (t.detach() for t in leaves)
    np.testing.assert_array_equal(
        y.detach().float().numpy(),
        real(x, s, b, w1.to(x.dtype), b1, w2.to(x.dtype), b2, fc=256).float().numpy())
    want = chan_ff_chunked_bwd_reference(x, dy, s, b, w1.to(x.dtype), b1, w2.to(x.dtype), fc=256)
    assert leaves[2].grad.dtype == torch.float32
    for name, leaf, w in zip(GRAD_NAMES[1:], leaves, want[1:]):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy(), err_msg=name)


def test_chunked_references_equal_the_monolithic_math_in_f32():
    """In f32 the chunked block is the monolithic one summed in another
    order: the forward within 2e-5 of ``chan_ff_reference``, dxa-fed dx and
    the LN grads within ``BWD_TOL``, the row-sum grads equal."""
    ta = _torch_args(_args(seed=5), torch.float32)
    np.testing.assert_allclose(chan_ff_chunked_reference(*ta, fc=512).numpy(),
                               mixer_cuda.chan_ff_reference(*ta).numpy(), **TOL["float32"])
    x, s, b, w1, b1, w2, _ = ta
    dy = torch.from_numpy(_dy(seed=6).astype(np.float32))
    got = chan_ff_chunked_bwd_reference(x, dy, s, b, w1, b1, w2, fc=128)
    want = mixer_cuda.chan_ff_bwd_reference(x, dy, s, b, w1, b1, w2)
    _assert_grads_close([g.numpy() for g in got], [g.numpy() for g in want],
                        BWD_TOL["float32"], "chunked vs monolithic")
    for i in (3, 4, 5, 6):  # dw1, db1, dw2, db2 do not depend on the chunking
        np.testing.assert_array_equal(got[i].numpy(), want[i].numpy(), err_msg=GRAD_NAMES[i])


@pytest.mark.parametrize("fc", [0, 300, 4096, 512.0])
def test_chunked_block_rejects_a_bad_chunk_width(fc):
    ta = _torch_args(_args(seed=7), torch.bfloat16)
    with pytest.raises(ValueError, match="fc must be a positive divisor"):
        chan_ff_block_chunked(*ta, fc=fc)


def test_ported_tool_main_on_cpu_returns_its_times():
    res = profile_chanff_chunk.main(fcs=(512, 1024), R=8, device="cpu", rounds=1, reps=1)
    assert res["R"] == 8 and sorted(res["parity"]) == [512, 1024]
    # both sides keep the products in f32 apart from the monolithic block's
    # bf16 rounding before the bias: a chain of 12 differs by bf16 roundings
    assert all(0.0 <= v < 0.5 for v in res["parity"].values()), res["parity"]
    for mode in ("fwd", "fwd+bwd"):
        assert sorted(res[mode], key=str) == sorted(["base", 512, 1024], key=str)
        assert all(np.isfinite(v) and v > 0 for v in res[mode].values())
    assert profile_chanff_chunk.kernel_launches((512, 1024), rounds=5, reps=10) == (
        2 * 12 * (1 + 2 * 51), 2 * 12 * 51)


def test_ported_tool_weights_are_the_jax_tools():
    ws = profile_chanff_chunk.weights(np.random.RandomState(0), "cpu")
    jws = _tool().WS
    assert len(ws) == len(jws) == 12
    for w, jw in zip((ws[0], ws[-1]), (jws[0], jws[-1])):
        for t, j in zip(w, jw):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
