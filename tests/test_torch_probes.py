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
since both sides compute in f32 (or f64) and round once. GELU's within that
plus 0.5 |x| (ERF_ABS["xla"] + ERF_ABS["torch_f64"]): for x << 0 its formula
0.5 x (1 + erf(x / sqrt 2)) cancels in f32 before the rounding, so JAX's
output carries its erf's absolute error times 0.5 |x|, and the plain version
(f64) carries its own. Each library's erf is held to those bounds against the
f64 erf over every finite bf16 x, the whole set the probe can see
(``test_erf_is_held_to_f64_over_every_bf16_input``), so the GELU bound holds
on any machine where those checks pass. An f32 output within
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
import math
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
from pips_tpu_torch.tools import (debug_mixer_kernel, debug_pallas7, probe_mosaic_ops,
                                  profile_pipelines)

TOOLS_DIR = Path(__file__).resolve().parents[1] / "tools"
PORTS = {"debug_mixer_kernel": debug_mixer_kernel, "debug_pallas7": debug_pallas7,
         "probe_mosaic_ops": probe_mosaic_ops}
F32_REL = 1e-5
BF16_REL = 2.0 ** -8  # one bf16 ulp is at most this much of the value
# |erf - f64 erf| over erf(x / sqrt 2) for every finite bf16 x, each computed
# as its caller does: XLA's in f32 as k_erf calls it (a rational approximation
# evaluated in f32, whose roundings follow the host's vector width and FMA
# use; 3.06 f32 ulps of 1 (2^-24) with jax 0.9 on an AVX512 host, held to 8),
# PyTorch's f32 erf (the former plain version: 0.94 ulps with torch 2.13 on
# that host; vectorised builds have used a 1.5e-7 (2.5 ulp) approximation;
# held to 8) and PyTorch's f64 erf, the plain version's (an f64 ulp against
# libm's, held to 2^-50)
ERF_ABS = {"xla": 2.0 ** -21, "torch_f32": 2.0 ** -21, "torch_f64": 2.0 ** -50}
GELU_SLACK = 0.5 * (ERF_ABS["xla"] + ERF_ABS["torch_f64"])  # times |x|


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


def _assert_bf16_close(got: torch.Tensor, want: np.ndarray, what: str, slack=0.0, x=None):
    """Within one bf16 ulp plus ``slack`` elementwise; a miss names the worst
    input ``x`` (where given), both values and the bound there."""
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape, what
    g = got.float().numpy()
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(want)))
    bound = np.ldexp(1.0, e - 8) + slack
    err = np.abs(g - want)
    bad = err > bound
    if bad.any():
        i = np.unravel_index(np.argmax(err / bound), err.shape)
        at = "" if x is None else f" x={float(np.asarray(x)[i])!r}"
        pytest.fail(f"{what}: {bad.sum()} values beyond one bf16 ulp + slack; worst at "
                    f"{i}{at}: got {g[i]!r}, want {want[i]!r}, |diff| {err[i]:.4g} > bound "
                    f"{bound[i]:.4g}")


@functools.lru_cache(maxsize=None)
def _every_bf16():
    """Every finite bf16 value, as f32 numpy."""
    v = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)]


@pytest.mark.parametrize("lib", sorted(ERF_ABS))
def test_erf_is_held_to_f64_over_every_bf16_input(lib):
    """erf(x / sqrt 2) for every finite bf16 x, as each caller computes it,
    within ``ERF_ABS[lib]`` of the f64 erf of the exact quotient."""
    x = _every_bf16()
    want = np.array([math.erf(v / math.sqrt(2.0)) for v in x.astype(np.float64)])
    if lib == "xla":
        got = jax.jit(lambda xf: jax.lax.erf(xf / np.sqrt(2.0)))(jnp.asarray(x))
        assert got.dtype == jnp.float32
        got = np.asarray(got, np.float64)
    elif lib == "torch_f32":
        got = torch.erf(torch.from_numpy(x) / math.sqrt(2.0)).double().numpy()
    else:
        got = torch.erf(torch.from_numpy(x).double() / math.sqrt(2.0)).numpy()
    err = np.abs(got - want)
    i = int(np.argmax(err))
    assert err[i] <= ERF_ABS[lib], (f"{lib}: |erf - f64 erf| {err[i]:.4g} > {ERF_ABS[lib]:.4g} "
                                    f"at x={x[i]!r}: {got[i]!r} against {want[i]!r}")


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
        xs = x.float().numpy()
        _assert_bf16_close(gelu_reference(x), want, probe, slack=GELU_SLACK * np.abs(xs), x=xs)
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


# row_contract's layouts: the probes (A, A2 and B are one layout) and the
# smoke's edges, as (G, R, CA, CB, a's batch and row strides, b's) -> the
# launch plan (fast path, splits, rows a block, scratch)
CONTRACT_PLANS = {
    "probe A": ((1, 6144, 6, 64, (0, 6), (0, 64)), (True, 8, 768, None)),
    "probe C": ((28, 24, 6, 64, (6, 1536), (0, 16384)), (True, 1, 32, None)),
    "R=1000": ((1, 1000, 6, 64, (6000, 6), (64000, 64)), (True, 8, 128, None)),
    "G=3 R=100 b_bs=0": ((3, 100, 6, 64, (600, 6), (0, 64)), (True, 2, 64, None)),
    "CA=20 CB=24": ((1, 1000, 20, 24, (20000, 20), (24000, 24)),
                    (False, 8, 125, (8, 1, 20, 24))),
    "odd CA": ((2, 50, 5, 64, (250, 5), (3200, 64)), (False, 1, 50, None)),
    "CB=32": ((1, 1000, 6, 32, (6000, 6), (32000, 32)), (False, 8, 125, (8, 1, 6, 32))),
    "R=2100": ((1, 2100, 6, 64, (0, 6), (0, 64)), (True, 5, 512, None)),
    "R=9000": ((1, 9000, 6, 64, (0, 6), (0, 64)), (False, 8, 1125, (8, 1, 6, 64))),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_PLANS))
def test_row_contract_launch_plan(case):
    """One launch whose blocks cover the rows: every block holds at least one
    row, the fast path's rows are whole k-steps of 16 and whole TMA boxes that
    fit its shared memory, and only the general path with more than one split
    has a scratch."""
    (G, R, CA, CB, a_st, b_st), (fast, splits, rows, scratch) = CONTRACT_PLANS[case]
    plan = row_contract_cuda.launch_plan(G, R, CA, CB, a_st, b_st)
    assert (plan.fast, plan.splits, plan.rows_per_block, plan.scratch) == (
        fast, splits, rows, scratch)
    assert plan.grid == (splits, G, 1)
    assert (splits - 1) * rows < R <= splits * rows and splits <= row_contract_cuda.MAX_SPLITS
    if fast:
        assert rows % 16 == 0 and rows % min(rows, row_contract_cuda.BOX_ROWS) == 0
        assert rows <= row_contract_cuda.FAST_ROWS
    # a pointer the fast path's copies cannot take sends the same shape to the general path
    assert not row_contract_cuda.launch_plan(G, R, CA, CB, a_st, b_st, b_align=8).fast


def test_row_contract_launch_plan_grid_beyond_y():
    plan = row_contract_cuda.launch_plan(70000, 24, 6, 64, (6, 1536), (0, 16384))
    assert plan.grid == (1, 65535, 2)


@pytest.mark.parametrize("case", ["R=1000", "G=3 R=100 b_bs=0", "CA=20 CB=24", "odd CA"])
def test_row_contract_edges_on_cpu_match_numpy(case):
    """The CPU path at the smoke's edge shapes against np.einsum in f64 on
    the same numpy inputs (bf16 values), within the probes' f32 bound."""
    (G, R, CA, CB, _, b_st), _ = CONTRACT_PLANS[case]
    rng = np.random.RandomState(len(case))
    a = torch.from_numpy(rng.rand(G, R, CA) - 0.5).to(torch.bfloat16)
    b = torch.from_numpy(rng.rand(1 if b_st[0] == 0 else G, R, CB) - 0.5).to(torch.bfloat16)
    b = b.expand(G, R, CB)
    got = row_contract(a, b, probe="edge")
    an, bn = a.double().numpy(), b.double().numpy()
    want = np.einsum("grc,gro->gco", an, bn)
    terms = torch.from_numpy(np.einsum("grc,gro->gco", np.abs(an), np.abs(bn)))
    _assert_f32_close(got, want, terms, case)
    assert got.shape == (G, CA, CB)


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


@pytest.mark.parametrize("case", ["columns", "row_stride", "w1_layout"])
def test_cuda_stream_accum_rejects_what_its_tiles_cannot_take(case, monkeypatch):
    """The CUDA path's own checks, made before any build or launch: N a
    multiple of the kernel's column tile, x's row stride a multiple of 8 (its
    rows are TMA boxes), w1 contiguous."""
    monkeypatch.setattr(mixer_probes_cuda, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(mixer_probes_cuda, "_kernel", lambda *a: pytest.fail("built a kernel"))
    cols = mixer_probes_cuda.STREAM_COLS
    z = functools.partial(torch.zeros, dtype=torch.bfloat16)
    x, w1 = z(4, 1024), z(2, 512, cols)
    if case == "columns":
        w1 = z(2, 512, cols + 16)
    elif case == "row_stride":
        x = z(4, 1028)[:, :1024]
    else:
        w1 = z(2, 512, 2 * cols)[:, :, :cols]
    with pytest.raises(ValueError, match="stream_accum"):
        stream_accum(x, w1)


@pytest.mark.parametrize("source", sorted(profile_pipelines.VARIANTS))
def test_pipeline_variants_still_match_their_kernels(source):
    """Each variant of ``tools/profile_pipelines.py`` takes a phase out of the
    kernel's source, or of a header the source includes, by replacing a line
    that must be there exactly once in all of them."""
    csrc = Path(mixer_probes_cuda.__file__).resolve().parents[1] / "csrc"
    files = profile_pipelines._sources(source)
    assert files[f"{source}.cu"] == (csrc / f"{source}.cu").read_text()
    for subs in profile_pipelines.VARIANTS[source].values():
        for old, new in subs:
            assert sum(text.count(old) for text in files.values()) == 1, old
            assert new != old
        changed = profile_pipelines.variant_sources(source, subs)
        assert all(text != files[name] for name, text in changed.items())
        assert bool(changed) == bool(subs)


def test_pipeline_variant_refuses_a_line_that_is_not_there_once():
    """A variant whose line is missing, or found in more than one place of the
    source and its headers, raises instead of building the kernel unchanged."""
    with pytest.raises(RuntimeError, match="no longer hold"):
        profile_pipelines.variant_sources("chanff_fwd", [("no such line\n", "x")])
    with pytest.raises(RuntimeError, match="no longer hold"):  # in both the source and a header
        profile_pipelines.variant_sources("chanff_fwd", [("namespace {", "namespace x {")])
    files = profile_pipelines._sources("chanff_fwd")
    assert {"chanff_fwd.cu", "chanff_tiles.cuh", "async_copy.cuh", "chanff_rows.cuh",
            "mma_bf16.cuh"} == set(files)


def test_profile_pipelines_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_pipelines.main()


@pytest.mark.parametrize("name", sorted(PORTS))
def test_ported_tools_need_cuda_unless_cpu_is_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORTS[name].main()
