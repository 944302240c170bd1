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
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu_torch.kernels import chanff_chunk_cuda, mixer_cuda
from pips_tpu_torch.kernels.chanff_chunk_cuda import (FCS, chan_ff_block_chunked,
                                                      chan_ff_chunked_bwd_reference,
                                                      chan_ff_chunked_reference, chunk_plan)
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


# ---- the launch plan (``chunk_plan``), on the host

_SRC = chanff_chunk_cuda._build.CSRC / "chanff_chunk.cu"


def _constexpr(name: str) -> int:
    """The value of ``constexpr int <name> = <int>;`` in ``csrc/chanff_chunk.cu``."""
    m = re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text())
    assert m, f"chanff_chunk.cu defines no constexpr int {name}"
    return int(m.group(1))


def _c_args(entry: str) -> tuple:
    """(pointer, int) parameter counts of the C entry ``entry``."""
    m = re.search(rf"int {entry}\(([^)]*)\)", _SRC.read_text())
    params = [p.strip() for p in m.group(1).split(",")]
    return (sum(p.startswith(("const void*", "void*")) and p != "void* stream" for p in params),
            sum(p.startswith("int ") for p in params))


def test_chunk_plan_constants_are_the_kernels():
    """The plan is laid out for what ``csrc/chanff_chunk.cu`` is compiled
    with: its row tile, largest cluster, slab widths and ring; the
    shared memory it reckons is the kernels' (the same sum of xa, two slabs,
    the ring's slots and barriers and the backward's statistics); the C
    entries take the pointers and integers the wrapper passes, the plan's
    row tile and split among them."""
    c = chanff_chunk_cuda
    assert _constexpr("kRowTile") == c.ROW_TILE == 64
    assert _constexpr("kMaxSplit") == c.MAX_SPLIT
    assert (_constexpr("kFwdSlab"), _constexpr("kBwdSlab")) == (c.FWD_SLAB, c.BWD_SLAB)
    assert (_constexpr("kFwdStages"), _constexpr("kFwdSlot")) == (c.FWD_STAGES, c.FWD_SLOT)
    assert (_constexpr("kBwdStages"), _constexpr("kBwdSlot")) == (c.BWD_STAGES, c.BWD_SLOT)
    assert _constexpr("kAlign") == c.ALIGN
    src = _SRC.read_text()
    assert "constexpr int kSmem = kAlign + kTileBytes + 2 * kSlabBytes + Ring::kSmem + kSlab * 4;" \
        in src
    assert ("constexpr int kSmem =\n    kAlign + kTileBytes + 2 * kSlabBytes + Ring::kSmem + "
            "kRowTile * 8 + kRed * 4 + kSlab * 4;") in src
    assert "constexpr int kRed = 2 * 2 * 4 * kHalf;" in src and c.BWD_SLAB // 2 * 16 * 4 == 4096
    assert "static constexpr int kSmem = kStages * kSlot + 2 * kStages * 8;" in src
    assert c.FWD_SMEM == 1024 + 65536 + 2 * 64 * 256 * 2 + 3 * (32768 + 16) + 1024 <= c.SMEM_LIMIT
    assert c.BWD_SMEM == (1024 + 65536 + 2 * 64 * 128 * 2 + 3 * (40960 + 16) + 512 + 4096
                          + 512) <= c.SMEM_LIMIT
    for name, (n_ptr, n_int) in c._ENTRIES.items():
        assert _c_args(name) == (n_ptr, n_int), name
    assert "int row_tile, int split, int device, void* stream" in src
    for kernel in ("chanff_chunk_fwd(", "chanff_chunk_bwd_rows("):
        assert re.search(r"__global__ void __launch_bounds__\(kThreads, 1\)\n" + re.escape(kernel),
                         src), kernel


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("fc", FCS)
@pytest.mark.parametrize("R", [1, 100, 800, 1024, 24576, 61440])
def test_chunk_plan(R, fc):
    """Both passes cover every row in 64-row tiles; each row tile's blocks
    are one cluster whose F runs are contiguous whole chunks in chunk order
    (so the rank-order sum is the reference's chunk order); the clusters
    and their blocks fit the card at once; a block's shared memory fits;
    the forward is one kernel with no scratch (g1 stays on chip), the
    backward its row kernel and the finishing launches, its partials in
    tiles of the row tile."""
    F = 2048
    plan = chunk_plan(R, F, fc)
    tiles = _cdiv(R, 64)
    c = chanff_chunk_cuda
    for p in (plan.fwd, plan.bwd):
        assert p.row_tile == c.ROW_TILE == 64
        assert p.grid == (p.split, tiles, 1) and (tiles - 1) * 64 < R <= tiles * 64
        assert p.cluster == (p.split, 1, 1) and p.split in (1, 2, 4, 8)
        assert len(p.runs) == p.split and p.runs[0][0] == 0 and p.runs[-1][1] == F
        assert all(a[1] == b[0] for a, b in zip(p.runs, p.runs[1:]))
        assert all(f1 > f0 and f0 % fc == 0 and (f1 - f0) % fc == 0 for f0, f1 in p.runs)
        assert len({f1 - f0 for f0, f1 in p.runs}) == 1  # equal runs: the kernel's rank * run
        # a split's blocks and clusters all fit the card at once (no cluster: waves)
        assert p.split == 1 or (tiles * p.split <= mixer_cuda.SMS
                                and tiles <= c.CLUSTERS_AT_ONCE[p.split])
        assert p.smem <= c.SMEM_LIMIT == 232448
    assert plan.fwd.kernels == ("chanff_chunk_fwd",) and plan.fwd.scratch == {}
    assert plan.bwd.kernels == ("chanff_chunk_bwd_rows",) + tuple(
        f"chanff_bwd_{k}" for k in list(plan.finish.grids)[-2:])
    assert list(plan.finish.grids)[-2:] == ["wgrad", "colsum"]
    bf16, f32 = torch.bfloat16, torch.float32
    assert plan.bwd.scratch == {
        "xa": ((R, 512), bf16), "g1": ((R, F), bf16), "da1": ((R, F), bf16),
        "part_d": ((tiles, 3, 512), f32), "part_f": ((tiles, F), f32),
        "wsplit": plan.finish.scratch["wsplit"]}
    # the split is the most the chunks and the card allow
    want = 1
    for s in (8, 4, 2):
        if (F // fc) % s == 0 and tiles * s <= 132 and tiles <= c.CLUSTERS_AT_ONCE[s]:
            want = s
            break
    assert plan.fwd.split == plan.bwd.split == want
    if R == 1024:  # the tool's rows: 16 row tiles, clusters of four where the chunks allow
        assert want == {128: 4, 256: 4, 512: 4, 1024: 2}[fc]
    if R >= 24576:
        assert want == 1


@pytest.mark.parametrize("R,F,fc", [(0, 2048, 512), (100, 2048, 384), (100, 2048, 64),
                                    (100, 1000, 128)])
def test_chunk_plan_refuses_what_the_kernels_do_not_take(R, F, fc):
    with pytest.raises(ValueError, match="no chunked plan"):
        chunk_plan(R, F, fc)
