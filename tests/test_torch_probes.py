"""The port's Mosaic probe kernels and their three tools against the JAX tools.

``kernels/mixer_probes_cuda.py`` (``gelu``, ``ln_slice``, ``stream_accum``),
``kernels/corr_rows_cuda.py`` and ``kernels/row_contract_cuda.py`` replace
the eight ``pallas_call`` probes of ``tools/debug_mixer_kernel.py``,
``tools/debug_pallas7.py`` and ``tools/probe_mosaic_ops.py``. Here their
plain versions, which the CUDA kernels are held to on the card, are held to
the JAX tools themselves: each tool is loaded by file path once per module
(loading runs its probes, in Pallas interpret mode) and its kernels are run
on its own inputs, which the port's ``inputs()`` must reproduce bit for bit.
``debug_mixer_kernel``'s calls are inline lambdas, so the test rebuilds its
three ``pallas_call``s from the tool's own kernel bodies and specs.

Tolerances: a bf16 output within one bf16 ulp (of the larger magnitude),
since both sides compute in f32 and round once; GELU's within that plus
|x| 2^-23, because for x << 0 its formula 0.5 x (1 + erf(x / sqrt 2))
cancels in f32 before the rounding, and XLA's erf and PyTorch's differ there
by an f32 ulp of 1 (seen: ten bf16 ulps at x = -4.84, one f32 ulp of erf;
the slack allows four); an f32 output within
1e-5 of the sum of |term| behind it, since bf16 products are exact in f32
and only the order of the f32 sums differs. A tool's sums (``main`` on the
CPU against what the JAX tool prints, or the sum of its output where it
prints none) within the same relative bound of the sum of |output|: the
``ln_slice`` sum cancels to 0.35 over 65,536 values.
"""

import contextlib
import functools
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pips_tpu_torch.kernels import corr_rows_cuda, mixer_probes_cuda, row_contract_cuda
from pips_tpu_torch.kernels.corr_rows_cuda import corr_rows, corr_rows_reference
from pips_tpu_torch.kernels.mixer_probes_cuda import (gelu, gelu_reference, ln_slice,
                                                      ln_slice_reference, stream_accum,
                                                      stream_accum_reference)
from pips_tpu_torch.kernels.row_contract_cuda import row_contract, row_contract_reference
from pips_tpu_torch.tools import debug_mixer_kernel, debug_pallas7, probe_mosaic_ops

TOOLS_DIR = Path(__file__).resolve().parents[1] / "tools"
PORTS = {"debug_mixer_kernel": debug_mixer_kernel, "debug_pallas7": debug_pallas7,
         "probe_mosaic_ops": probe_mosaic_ops}
F32_REL = 1e-5
BF16_REL = 2.0 ** -8  # one bf16 ulp is at most this much of the value


@functools.lru_cache(maxsize=None)
def _tool(name):
    """The JAX tool as a module, and what loading it printed."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", TOOLS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    return mod, out.getvalue()


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_mixer_probes():
    """The three probes of ``debug_mixer_kernel`` (:63-75), rebuilt from the
    tool's kernel bodies and specs: {name: f32 numpy output}."""
    mod, _ = _tool("debug_mixer_kernel")
    TN, S, D, F = mod.TN, mod.S, mod.D, mod.F
    with pltpu.force_tpu_interpret_mode():
        erf = pl.pallas_call(
            mod.k_erf, out_shape=jax.ShapeDtypeStruct((TN, S * D), jnp.bfloat16))(mod.x)
        ln = pl.pallas_call(
            mod.k_ln_slice, out_shape=jax.ShapeDtypeStruct((TN, D), jnp.bfloat16))(mod.x)
        acc = pl.pallas_call(
            mod.k_block_stream,
            grid=(12,),
            in_specs=[pl.BlockSpec((TN, S * D), lambda b: (0, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec((1, D, F), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((TN, F), lambda b: (0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((TN, F), jnp.float32))(mod.x, mod.w1)
    assert erf.dtype == ln.dtype == jnp.bfloat16 and acc.dtype == jnp.float32
    return {"erf": _np(erf), "ln_slice": _np(ln), "block_stream_accum": _np(acc)}


def _assert_bf16_close(got: torch.Tensor, want: np.ndarray, what: str, slack=0.0):
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape, what
    g = got.float().numpy()
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(want)))
    ulp = np.ldexp(1.0, e - 8)
    bad = np.abs(g - want) > ulp + slack
    assert not bad.any(), f"{what}: {bad.sum()} values more than one bf16 ulp apart"


def _assert_f32_close(got: torch.Tensor, want: np.ndarray, terms: torch.Tensor, what: str):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, what
    err = np.abs(got.numpy() - want)
    tol = F32_REL * terms.numpy()
    assert (err <= tol).all(), f"{what}: worst err/tol {np.max(err / np.maximum(tol, 1e-30)):.3g}"


@pytest.mark.parametrize("name", sorted(PORTS))
def test_ported_inputs_are_the_jax_tools(name):
    mod, _ = _tool(name)
    got = PORTS[name].inputs("cpu")
    want = [getattr(mod, n) for n in {"debug_mixer_kernel": ("x", "w1"),
                                      "debug_pallas7": ("fmap", "targets", "coords"),
                                      "probe_mosaic_ops": ("a0", "b0")}[name]]
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(), _np(j))


@pytest.mark.parametrize("probe", ["erf", "ln_slice", "block_stream_accum"])
def test_mixer_probe_references_match_jax(probe):
    want = _jax_mixer_probes()[probe]
    x, w1 = debug_mixer_kernel.inputs("cpu")
    if probe == "erf":
        _assert_bf16_close(gelu_reference(x), want, probe,
                           slack=2.0 ** -23 * np.abs(x.float().numpy()))
    elif probe == "ln_slice":
        _assert_bf16_close(ln_slice_reference(x, debug_mixer_kernel.D), want, probe)
    else:
        _assert_f32_close(stream_accum_reference(x, w1), want,
                          stream_accum_reference(x.abs(), w1.abs()), probe)


def _corr_rows_vs_jax(mod):
    with pltpu.force_tpu_interpret_mode():
        want = _np(mod.run(mod.k_rows))
    args = [torch.from_numpy(np.array(a)) for a in (mod.fmap, mod.targets, mod.coords)]
    fmap, targets, coords = args
    got = corr_rows_reference(fmap, targets, coords, mod.H, mod.W, mod.r)
    terms = corr_rows_reference(fmap.abs(), targets.abs(), coords, mod.H, mod.W, mod.r)
    _assert_f32_close(got, want, terms, "rowwise 3d-reduce")
    return got


def test_corr_rows_reference_matches_jax_run():
    mod, _ = _tool("debug_pallas7")
    got = _corr_rows_vs_jax(mod)
    assert got.shape == (1, 8, 49)
    assert (got == 0).any() and (got != 0).any()  # H=16: some windows leave the map


def test_corr_rows_reference_matches_jax_off_every_edge(monkeypatch):
    """Points on and beyond every edge, integer and negative fractional
    coordinates (floor(-0.5) = -1), the same JAX kernel on them."""
    mod, _ = _tool("debug_pallas7")
    c = np.array([[-0.5, -0.5], [0.0, 0.0], [mod.W - 1, mod.H - 1], [mod.W + 2.5, 3.0],
                  [5.25, mod.H + 2.0], [-3.0, 7.75], [64.0, -4.0], [mod.W - 3.5, 1.5]])
    monkeypatch.setattr(mod, "coords", jnp.asarray(c[None], jnp.float32))
    got = _corr_rows_vs_jax(mod)
    assert (got[0, 4] == 0).sum() > 0 and (got[0, 2] != 0).sum() > 0


@pytest.mark.parametrize("probe", ["probe_a", "probe_a2", "probe_b", "probe_c"])
def test_row_contract_probes_match_jax(probe):
    mod, _ = _tool("probe_mosaic_ops")
    with pltpu.force_tpu_interpret_mode():
        want = _np(getattr(mod, probe)(mod.a0, mod.b0))
    a, b = probe_mosaic_ops.inputs("cpu")
    fn = getattr(probe_mosaic_ops, probe)
    got = fn(a, b)
    _assert_f32_close(got, want, fn(a.abs(), b.abs(), plain=True), probe)
    assert got.shape == ((168, 64) if probe == "probe_c" else (6, 64))


def _jax_outputs(name):
    """The JAX tool's output of each probe, by the port's probe names."""
    mod, _ = _tool(name)
    if name == "debug_mixer_kernel":
        return _jax_mixer_probes()
    if name == "debug_pallas7":
        with pltpu.force_tpu_interpret_mode():
            return {"rowwise 3d-reduce": _np(mod.run(mod.k_rows))}
    with pltpu.force_tpu_interpret_mode():
        return {label: _np(getattr(mod, fn)(mod.a0, mod.b0)) for label, fn in zip(
            probe_mosaic_ops.KERNELS, ("probe_a", "probe_a2", "probe_b", "probe_c"))}


@pytest.mark.parametrize("name", sorted(PORTS))
def test_ported_tool_main_on_cpu_matches_the_jax_tool(name):
    """Every probe the JAX tool reports OK; the port's sums within their bound
    of what it prints (``debug_mixer_kernel``) or of its outputs' sums."""
    _, printed = _tool(name)
    port = PORTS[name]
    res = port.main(device="cpu", rounds=1, reps=1)
    outs = _jax_outputs(name)
    assert sorted(res) == sorted(port.KERNELS) == sorted(outs)
    for probe, r in res.items():
        line = next(ln for ln in printed.splitlines() if probe in ln)
        assert "OK" in line and "FAIL" not in line, line
        m = re.search(r"sum=(-?[0-9.]+)", line)
        want = float(m.group(1)) if m else float(outs[probe].sum(dtype=np.float64))
        rel = BF16_REL if probe in ("erf", "ln_slice") else F32_REL
        bound = rel * float(np.abs(outs[probe]).sum(dtype=np.float64)) + 1e-4
        assert abs(r["sum"] - want) <= bound, (probe, r["sum"], want, bound)
        assert r["max_abs_err"] == 0.0 and r["ms"] > 0  # on the CPU the kernel is the plain version
    assert port.kernel_launches(5, 10) == {k: 52 for k in port.kernel_launches(1, 1)}


def test_probe_wrappers_on_cpu_are_the_plain_versions(monkeypatch):
    """On CPU tensors each wrapper returns its plain version bit for bit, builds
    nothing and counts no launch."""
    for mod in (mixer_probes_cuda, row_contract_cuda, corr_rows_cuda):
        monkeypatch.setattr(mod, "_kernel", lambda *a: pytest.fail("built a kernel"))
    before = (dict(mixer_probes_cuda.launches), dict(row_contract_cuda.launches),
              corr_rows_cuda.launches)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(16, 640)).to(torch.bfloat16)
    w1 = torch.from_numpy(rng.randn(3, 512, 32) * 0.02).to(torch.bfloat16)
    assert torch.equal(gelu(x), gelu_reference(x))
    assert torch.equal(ln_slice(x, 512), ln_slice_reference(x, 512))
    assert torch.equal(stream_accum(x, w1), stream_accum_reference(x, w1))
    fmap = torch.from_numpy(rng.rand(2, 6 * 10, 40)).float()
    targets = torch.from_numpy(rng.rand(2, 5, 40)).float()
    coords = torch.from_numpy(rng.rand(2, 5, 2) * 14 - 2).float()
    assert torch.equal(corr_rows(fmap, targets, coords, 6, 10, 2),
                       corr_rows_reference(fmap, targets, coords, 6, 10, 2))
    a = torch.from_numpy(rng.rand(3, 70, 5)).to(torch.bfloat16)
    b = torch.from_numpy(rng.rand(3, 70, 9)).to(torch.bfloat16)
    assert torch.equal(row_contract(a, b, probe="t"), row_contract_reference(a, b))
    assert before == (dict(mixer_probes_cuda.launches), dict(row_contract_cuda.launches),
                      corr_rows_cuda.launches)


@pytest.mark.parametrize("case", ["stream_accum", "corr_rows", "row_contract", "ln_slice"])
def test_probe_wrappers_reject_bad_shapes(case):
    z = torch.zeros
    with pytest.raises(ValueError):
        if case == "stream_accum":
            stream_accum(z(4, 512, dtype=torch.bfloat16), z(2, 256, 16, dtype=torch.bfloat16))
        elif case == "corr_rows":
            corr_rows(z(1, 60, 8), z(1, 3, 8), z(1, 3, 2), 6, 11)
        elif case == "row_contract":
            row_contract(z(2, 5, 3, dtype=torch.bfloat16), z(2, 6, 4, dtype=torch.bfloat16))
        else:
            ln_slice(z(4, 256, dtype=torch.bfloat16), 512)


@pytest.mark.parametrize("name", sorted(PORTS))
def test_ported_tools_need_cuda_unless_cpu_is_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORTS[name].main()
