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

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pips_tpu.kernels.mixer_pallas import chan_ff_block as jax_chan_ff_block
from pips_tpu.kernels.mixer_pallas import chan_ff_reference as jax_chan_ff_reference
from pips_tpu.models import mixer as jmixer
from pips_tpu_torch.convert import state_dict_from_flax
from pips_tpu_torch.kernels import chanff_chunk_cuda, mixer_cuda, token_cuda
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


# ---- the backward's launch plan (``mixer_cuda.bwd_plan``), on the host

_CSRC = mixer_cuda._build.CSRC


def _cdiv(a, b):
    return -(-a // b)


def _constexpr(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <int>;`` in ``csrc/<source>``."""
    m = re.search(rf"constexpr int {name} = (\d+);", (_CSRC / source).read_text())
    assert m, f"{source} defines no constexpr int {name}"
    return int(m.group(1))


def test_bwd_plan_constants_are_the_kernels():
    """The plan's tiles, splits and LN rows are those ``csrc/chanff_bwd.cu``
    is compiled with (its tiles and LN rows from ``chanff_tiles.cuh``, which
    it includes); the chunked path's partial tiles those of its kernel, whose
    row tiles they are."""
    src = "chanff_bwd.cu"
    assert '#include "chanff_tiles.cuh"' in (_CSRC / src).read_text()
    assert _constexpr("chanff_tiles.cuh", "kTileRows") == mixer_cuda.TILE_ROWS
    assert _constexpr("chanff_tiles.cuh", "kTileCols") == mixer_cuda.TILE_COLS
    assert _constexpr(src, "kMaxSplit") == mixer_cuda.MAX_SPLIT
    assert _constexpr("chanff_tiles.cuh", "kLnRows") == mixer_cuda.LN_ROWS
    assert _constexpr("chanff_chunk.cu", "kD") == chanff_chunk_cuda.KERNEL_D == 512
    assert mixer_cuda.KERNEL_D == (256, 512)
    assert "if ((D != 256 && D != 512) || F <= 0" in (_CSRC / src).read_text()
    assert _constexpr("chanff_chunk.cu", "kRowTile") == chanff_chunk_cuda.ROW_TILE
    assert re.search(r"constexpr int kRowTile = 64; +// rows of a block: one wgmma M, the "
                     r"partials' tiles", (_CSRC / "chanff_chunk.cu").read_text())
    assert chanff_chunk_cuda.chunk_plan(800, 2048, 512).bwd.row_tile == chanff_chunk_cuda.ROW_TILE
    assert f"<<<(unsigned)((n + {mixer_cuda.COLSUM_THREADS - 1}) / {mixer_cuda.COLSUM_THREADS}), " \
           f"{mixer_cuda.COLSUM_THREADS}" in (_CSRC / src).read_text()


@pytest.mark.parametrize("F", [2048, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [1, 800, 1024, 24576])
def test_bwd_plan(R, dtype, F):
    """Five launches a call whose grids cover R rows and F columns in
    128 x 128 tiles; K split only where the weight-grad tiles leave blocks
    the card holds idle, each split at least SPLIT_MIN_ROWS rows; scratch
    in the compute dtype and f32 partials per 128-row tile."""
    D = 512
    plan = mixer_cuda.bwd_plan(R, F, dtype)
    rt, ct = _cdiv(R, 128), _cdiv(F, 128)
    wtiles = 2 * (D // 128) * ct
    assert plan.launches == 5 and list(plan.grids) == ["ln", "act", "dxa", "wgrad", "colsum"]
    assert plan.tile_rows == 128
    assert plan.grids["ln"] == (_cdiv(R, 8), 1)
    assert plan.grids["act"] == (ct, rt) and plan.grids["dxa"] == (4, rt)
    assert plan.grids["wgrad"] == (wtiles, plan.split)
    slots = mixer_cuda.SMS * mixer_cuda.WGRAD_BLOCKS_PER_SM[dtype]
    assert 1 <= plan.split <= mixer_cuda.MAX_SPLIT
    if plan.split > 1:
        assert plan.split * wtiles <= slots and (plan.split - 1) * 512 < R
    else:
        assert 2 * wtiles > slots or R <= 512
    if F == 2048:  # 128 tiles: one an SM in bf16, two an SM fit in f32
        assert plan.split == (1 if dtype == torch.bfloat16 or R <= 512 else 2)
    colsum = 3 * D + F + (2 * D * F // 4 if plan.split > 1 else 0)
    assert plan.grids["colsum"] == (_cdiv(colsum, 256), 1)
    f32 = torch.float32
    want = {"xa": ((R, D), dtype), "g1": ((R, F), dtype), "da1": ((R, F), dtype),
            "stats": ((2, R), f32), "part_d": ((rt, 3, D), f32), "part_f": ((rt, F), f32),
            "wsplit": ((plan.split, 2, D * F), f32) if plan.split > 1 else None}
    assert plan.scratch == want and list(plan.scratch) == list(want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_buffers_allocate_the_plan(dtype):
    x = torch.zeros(800, 512, dtype=dtype)
    plan = mixer_cuda.bwd_plan(800, 2048, dtype)
    outs, scratch = mixer_cuda.bwd_buffers(x, plan)
    assert [(tuple(t.shape), t.dtype) for t in outs] == [
        ((800, 512), dtype), ((512,), torch.float32), ((512,), torch.float32),
        ((512, 2048), torch.float32), ((2048,), torch.float32), ((2048, 512), torch.float32),
        ((512,), torch.float32)]
    assert list(scratch) == list(plan.scratch)
    for name, spec in plan.scratch.items():
        got = scratch[name]
        assert (got is None and spec is None) or ((tuple(got.shape), got.dtype) == spec), name


@pytest.mark.parametrize("R", [800, 1024, 100])
def test_chunked_partials_are_what_the_column_sums_are_told(R, monkeypatch):
    """The F-chunked backward writes its partials in 64-row tiles (its row
    tiles); the buffers it gets hold ceil(R / 64) of them, and ``bwd_finish``
    hands the C entry that count, the 64 rows (which it checks against R) and
    the finishing plan's split with its scratch."""
    x = torch.zeros(R, chanff_chunk_cuda.KERNEL_D, dtype=torch.bfloat16)
    plan = chanff_chunk_cuda.chunk_plan(R, 2048, 512)
    rows = chanff_chunk_cuda.ROW_TILE
    assert plan.bwd.row_tile == rows == 64
    outs, scratch = chanff_chunk_cuda.bwd_buffers(x, plan)
    tiles = _cdiv(R, rows)
    assert tuple(scratch["part_d"].shape) == (tiles, 3, 512)
    assert tuple(scratch["part_f"].shape) == (tiles, 2048)
    assert tuple(scratch["g1"].shape) == (R, 2048) and scratch["xa"].dtype == torch.bfloat16
    assert "stats" not in scratch  # the row kernel keeps its LN statistics on chip
    calls = []

    def entry(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(mixer_cuda, "_kernel", lambda name: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(
        cuda_stream=7))
    mixer_cuda.bwd_finish(torch.zeros_like(x), outs, scratch, plan.finish, rows)
    (a,) = calls
    assert len(a) == 13 + 5 + 2  # pointers, R, F, nblk, part_rows, split, device, stream
    assert a[13:18] == (R, 2048, tiles, rows, plan.finish.split)
    assert a[18:] == (None, 7)  # a CPU tensor's device index, the stream
    assert a[12] is None and tiles == _cdiv(R, a[16])  # no split at F=2048 in bf16


# ---- the forward's launch plan (``mixer_cuda.fwd_plan``), on the host

def test_fwd_plan_constants_are_the_kernels():
    """The forward's plan is laid out for what ``csrc/chanff_fwd.cu`` is
    compiled with: the shared header's tiles and LN rows, its largest split
    (the C entry refuses more, and fewer than 64 columns of F a split), its
    three launches in the plan's order, the out product's clusters along z."""
    src = (_CSRC / "chanff_fwd.cu").read_text()
    assert '#include "chanff_tiles.cuh"' in src
    assert _constexpr("chanff_tiles.cuh", "kTileRows") == mixer_cuda.TILE_ROWS
    assert _constexpr("chanff_tiles.cuh", "kTileCols") == mixer_cuda.TILE_COLS
    assert _constexpr("chanff_tiles.cuh", "kLnRows") == mixer_cuda.LN_ROWS
    assert _constexpr("chanff_fwd.cu", "kMaxSplit") == mixer_cuda.FWD_MAX_SPLIT
    assert "split > kMaxSplit || split > F / 64" in src
    assert "if ((D != 256 && D != 512) || F <= 0" in src
    assert mixer_cuda.FWD_SPLIT_MIN_K % 64 == 0
    for dtype in ("tc", "simt"):
        body = src.split(f"namespace {dtype} {{")[1].split("cudaError_t launch(")[1]
        names = re.findall(
            r"(chanff_fwd_\w+?)(?:<[\w, ]+>)?<<<|launch_clusters\((chanff_fwd_\w+)(?:<D>)?,", body)
        assert [a or b for a, b in names] == [
            f"chanff_fwd_{k}{'_f32' if dtype == 'simt' and k != 'ln' else ''}"
            for k in ("ln", "act", "out")], names
    assert src.count("dim3(D / kTileCols, nblk, split),") == 2  # the out product in both dtypes
    assert src.count("dim3(1, 1, split)") == 2                   # its clusters along z


@pytest.mark.parametrize("F", [2048, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [1, 100, 2000, 2048, 24576, 61440])
def test_fwd_plan(R, dtype, F):
    """Three launches a call whose grids cover R rows and F columns in
    128 x 128 tiles (the LN pass 8 rows a block); the out product's K split
    only while the split tiles fit one to an SM, at most FWD_MAX_SPLIT runs of
    at least FWD_SPLIT_MIN_K columns; scratch xa and g1 in the compute
    dtype."""
    D = 512
    plan = mixer_cuda.fwd_plan(R, F, dtype)
    rt, ct = _cdiv(R, 128), _cdiv(F, 128)
    tiles = (D // 128) * rt
    assert plan.launches == 3 and list(plan.grids) == ["ln", "act", "out"]
    assert plan.tile_rows == 128 and (plan.R, plan.F, plan.dtype) == (R, F, dtype)
    assert plan.grids["ln"] == (_cdiv(R, 8), 1, 1)
    assert plan.grids["act"] == (ct, rt, 1)
    assert plan.grids["out"] == (D // 128, rt, plan.split)
    assert 1 <= plan.split <= mixer_cuda.FWD_MAX_SPLIT
    if plan.split > 1:
        assert plan.split * tiles <= mixer_cuda.SMS and F // plan.split >= 256
    else:
        assert 2 * tiles > mixer_cuda.SMS or F < 512
    # the choice at these shapes, in both dtypes: one row tile (R = 1 and
    # 100) splits K in four, a window of 256 points in two, the training
    # default and larger not at all; F = 64 never
    want = {1: 4, 100: 4, 2000: 2, 2048: 2, 24576: 1, 61440: 1}[R]
    assert plan.split == (want if F == 2048 else 1)
    assert plan.scratch == {"xa": ((R, D), dtype), "g1": ((R, F), dtype)}
    assert list(plan.scratch) == ["xa", "g1"]


def test_fwd_plan_refuses_what_the_kernels_do_not_take():
    for R, F, dtype in ((0, 2048, torch.bfloat16), (100, 96, torch.float32),
                        (100, 2048, torch.float16)):
        with pytest.raises(ValueError):
            mixer_cuda.fwd_plan(R, F, dtype)
    assert mixer_cuda.fwd_plan(2048, 2048, torch.bfloat16, sms=64).split == 1


# ---- the Pips2 refiner's width: D=256, F=1024 (the kernels take 256 and 512)

D2, F2 = 256, 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_ff_reference_matches_jax_at_d256(dtype):
    """The plain block at D=256, F=1024 on ragged rows (R=200) against JAX's
    plain ``chan_ff_reference`` and its interpret-mode kernel, at ``TOL``:
    the same formula, f32 sums in other orders (bf16: an operand one ulp off
    where a sum sits at a rounding boundary)."""
    a = _block_args(200, D=D2, F=F2, seed=11)
    ja = [jnp.asarray(v, jnp.float32) for v in a]
    ja[0] = ja[0].astype(getattr(jnp, dtype))
    want_ref = np.asarray(jax_chan_ff_reference(*ja), np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jax_chan_ff_block(*ja), np.float32)
    ta = _torch_args(a, getattr(torch, dtype))
    got = mixer_cuda.chan_ff_reference(*ta)
    assert got.dtype == ta[0].dtype and got.shape == (200, D2)
    np.testing.assert_allclose(got.float().numpy(), want_ref, **TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), want_kernel, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_ff_bwd_reference_matches_jax_vjp_at_d256(dtype):
    """The plain backward at D=256, F=1024 against ``jax.vjp`` of the JAX
    block (interpret mode), each grad within ``BWD_TOL`` of its largest
    magnitude (bf16 dx within two ulps), as at D=64; in f32 also against
    ``jax.vjp`` of JAX's plain reference, whose f32 autodiff is the same math."""
    R = 200
    a = _block_args(R, D=D2, F=F2, seed=12)
    dy = np.random.RandomState(13).randn(R, D2)
    cd = getattr(jnp, dtype)
    ja = [jnp.asarray(v, jnp.float32) for v in a]
    ja[0] = ja[0].astype(cd)
    jdy = jnp.asarray(dy, jnp.float32).astype(cd)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_chan_ff_block, *ja)
        want = vjp(jdy)
    x, s, b, w1, b1, w2, _ = _torch_args(a, getattr(torch, dtype))
    got = mixer_cuda.chan_ff_bwd_reference(x, torch.from_numpy(dy.astype(np.float32)).to(x.dtype),
                                           s, b, w1, b1, w2)
    got = [g.float().numpy() for g in got]
    _assert_grads_close(got, [want[0].astype(jnp.float32), *want[1:]], BWD_TOL[dtype],
                        f"{dtype} D={D2}", bf16_dx=dtype == "bfloat16")
    if dtype == "float32":
        _, vjp_ref = jax.vjp(jax_chan_ff_reference, *ja)
        _assert_grads_close(got, vjp_ref(jdy), BWD_TOL[dtype], "plain reference")


def _expected_fwd_split(R, dtype):
    """fwd_plan's split at D=256, F=1024: 2 * ceil(R / 128) out tiles, K split
    while the split tiles fit one to an SM, in at most four runs of 256."""
    return max(1, min(4, mixer_cuda.SMS // (2 * _cdiv(R, 128)), F2 // 256))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [100, 2048, 6144, 73728])
def test_plans_at_d256(R, dtype):
    """The plans at the Pips2 refiner's rows (a ragged tile, S=8 and S=24
    windows of 256 points, S=24 training: 4 x 768 x 24): two column tiles of
    the out product and of the dxa products (a cluster of two), 32
    weight-grad tiles, whose K split fills the blocks the card holds at once
    (four splits in bf16 from R=2048 on, in f32 eight from R=6144 on: at
    least 512 rows a split), and scratch of width 256."""
    fwd = mixer_cuda.fwd_plan(R, F2, dtype, D=D2)
    bwd = mixer_cuda.bwd_plan(R, F2, dtype, D=D2)
    rt = _cdiv(R, 128)
    assert fwd.launches == 3 and bwd.launches == 5
    assert fwd.grids == {"ln": (_cdiv(R, 8), 1, 1), "act": (8, rt, 1),
                         "out": (2, rt, fwd.split)}
    assert fwd.split == _expected_fwd_split(R, dtype)
    assert fwd.split == {100: 4, 2048: 4, 6144: 1, 73728: 1}[R]
    assert fwd.scratch == {"xa": ((R, D2), dtype), "g1": ((R, F2), dtype)}
    split = {100: 1, 2048: 4}.get(R, 4 if dtype == torch.bfloat16 else 8)
    assert bwd.split == split
    assert bwd.grids == {"ln": (_cdiv(R, 8), 1), "act": (8, rt), "dxa": (2, rt),
                         "wgrad": (32, split),
                         "colsum": (_cdiv(3 * D2 + F2 + (2 * D2 * F2 // 4 if split > 1 else 0),
                                          256), 1)}
    assert bwd.scratch["part_d"] == ((rt, 3, D2), torch.float32)
    assert bwd.scratch["wsplit"] == (((split, 2, D2 * F2), torch.float32) if split > 1 else None)
    outs, _ = mixer_cuda.bwd_buffers(torch.zeros(R, D2, dtype=dtype), bwd)
    assert [tuple(t.shape) for t in outs] == [(R, D2), (D2,), (D2,), (D2, F2), (F2,), (F2, D2),
                                              (D2,)]


@pytest.mark.parametrize("D", [64, 128, 384, 768])
def test_cuda_kernels_refuse_other_widths(D):
    """Only D of 256 and 512 has a kernel; any other width raises on the card
    (no fall back to the plain version), and has no plan."""
    with pytest.raises(ValueError, match="D in"):
        mixer_cuda._cuda_ready("chan_ff_block", (), 100, D, 1024)
    with pytest.raises(ValueError):
        mixer_cuda.fwd_plan(100, 1024, torch.bfloat16, D=D)
    with pytest.raises(ValueError):
        mixer_cuda.bwd_plan(100, 1024, torch.float32, D=D)
    for ok in mixer_cuda.KERNEL_D:
        mixer_cuda._cuda_ready("chan_ff_block", (), 100, ok, 1024)
    with pytest.raises(ValueError, match="F %"):
        mixer_cuda._cuda_ready("chan_ff_block", (), 100, 256, 1000)


# ---- the token half (``kernels.token_cuda``), on the host

def _token_half(dtype, P=5, S=8, D=64, seed=0):
    """A LayerNorm and a TokenMixFF with non-trivial parameters, and x (P, S, D)."""
    torch.manual_seed(seed)
    norm, token = mixer.LayerNorm(D), mixer.TokenMixFF(S, 4)
    with torch.no_grad():
        for p in list(norm.parameters()) + list(token.parameters()):
            p.copy_(torch.randn_like(p) * 0.3 + (1.0 if p is norm.scale else 0.0))
    x = (torch.randn(P, S, D) * (1 + 2 * torch.rand(P, S, 1))).to(dtype)
    return norm, token, x


def _token_params(norm, token):
    return (norm.scale, norm.bias, token.fc1.kernel, token.fc1.bias, token.fc2.kernel,
            token.fc2.bias)


@pytest.mark.parametrize("dtype,module_dtype", [(torch.float32, None), (torch.bfloat16, None),
                                                (torch.bfloat16, torch.bfloat16)])
def test_token_mix_reference_is_the_present_token_half(dtype, module_dtype):
    """The plain version is, bit for bit, the token half as MLPMixer computed
    it before the kernel, written out here: ``x + token(norm(x).to(x.dtype))``
    with LayerNorm's and TokenMixFF's forwards of then (the mixer hands
    TokenMixFF an x already in its compute dtype, so ``module_dtype`` is x's
    dtype or None)."""
    norm, token, x = _token_half(dtype)
    with torch.no_grad():
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        xa = ((xf - mu) * (torch.rsqrt(var + 1e-5) * norm.scale) + norm.bias).to(x.dtype)
        cd = module_dtype or xa.dtype
        h = xa.to(cd).transpose(1, 2) @ token.fc1.kernel.to(cd)
        h = torch.nn.functional.gelu(h + token.fc1.bias.to(cd), approximate="none")
        o = (h @ token.fc2.kernel.to(cd)).transpose(1, 2)
        want = x + (o + token.fc2.bias.to(cd)[None, :, None])
        got = token_cuda.token_mix_reference(x, *_token_params(norm, token))
    assert got.dtype == dtype and torch.equal(got, want)


def test_token_mix_block_on_cpu_is_the_plain_version(monkeypatch):
    norm, token, x = _token_half(torch.bfloat16)
    calls = []

    def spy(*args):
        calls.append(args)
        return args[0]

    monkeypatch.setattr(token_cuda, "token_mix_reference", spy)
    monkeypatch.setattr(token_cuda, "_kernel", lambda: pytest.fail("built a CUDA kernel"))
    before = token_cuda.launches, token_cuda.plain_calls
    with torch.no_grad():
        assert token_cuda.token_mix_block(x, *_token_params(norm, token)) is x
    assert len(calls) == 1 and (token_cuda.launches, token_cuda.plain_calls) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_mix_block_grads_are_the_plain_versions(dtype, monkeypatch):
    """On the CPU, where autograd records, the block is the plain version: the
    same value and the same gradient of x and of every parameter."""
    monkeypatch.setattr(token_cuda, "_kernel", lambda: pytest.fail("built a CUDA kernel"))
    norm, token, x = _token_half(dtype)
    params = _token_params(norm, token)
    grads = []
    for fn in (token_cuda.token_mix_block, token_cuda.token_mix_reference):
        xg = x.clone().requires_grad_(True)
        y = fn(xg, *params)
        dy = torch.from_numpy(np.random.RandomState(1).randn(*y.shape).astype(np.float32))
        g = torch.autograd.grad(y, (xg,) + params, dy.to(y.dtype))
        grads.append((y,) + g)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _stand_in(shape, dtype=torch.float32, requires_grad=False, device="cuda"):
    """What the dispatch reads of a tensor: device, shape, dtype, requires_grad."""
    return types.SimpleNamespace(device=torch.device(device), shape=torch.Size(shape),
                                 dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("case,takes", [
    ("bf16", True), ("f32", True), ("grad recording", False), ("grad on, none wanted", True),
    ("cpu", False), ("S=16", False), ("D=256", False), ("expansion 2", False),
    ("float16", False), ("no points", False)])
def test_token_mix_block_takes_the_kernel_only_where_it_may(case, takes):
    """The kernel computes a call only for a CUDA x at (S, 4S, D) = (8, 32,
    512) in bf16 or f32, with points, while autograd does not record:
    what the call itself shows, and nothing else."""
    P, S, D, H = 7680, 8, 512, 32
    dtype, device, grad = torch.bfloat16, "cuda", False
    if case == "f32":
        dtype = torch.float32
    elif case == "grad recording":
        grad = True
    elif case == "cpu":
        device = "cpu"
    elif case == "S=16":
        S, H = 16, 64
    elif case == "D=256":
        D = 256
    elif case == "expansion 2":
        H = 16
    elif case == "float16":
        dtype = torch.float16
    elif case == "no points":
        P = 0
    args = (_stand_in((P, S, D), dtype, device=device), _stand_in((D,)), _stand_in((D,)),
            _stand_in((S, H), requires_grad=grad), _stand_in((H,)), _stand_in((H, S)),
            _stand_in((S,)))
    with torch.set_grad_enabled(case.startswith("grad")):
        assert token_cuda.takes_kernel(args) is takes
    with torch.no_grad():  # nothing records: only the shape, dtype and device decide
        assert token_cuda.takes_kernel(args) is (takes or case == "grad recording")


@pytest.mark.parametrize("bad", ["x_rank", "w1_shape", "b1_shape", "w2_shape", "b2_shape",
                                 "ln_scale_shape", "ln_bias_dtype", "w1_bf16"])
def test_token_mix_block_rejects_bad_inputs(bad):
    norm, token, x = _token_half(torch.bfloat16)
    s, b, w1, b1, w2, b2 = (t.detach() for t in _token_params(norm, token))
    if bad == "x_rank":
        x = x.reshape(-1, x.shape[-1])
    elif bad == "w1_shape":
        w1 = w1[:, :-1]
    elif bad == "b1_shape":
        b1 = b1[:-1]
    elif bad == "w2_shape":
        w2 = w2.t()
    elif bad == "b2_shape":
        b2 = torch.cat([b2, b2])
    elif bad == "ln_scale_shape":
        s = s[:-1]
    elif bad == "ln_bias_dtype":
        b = b.double()
    else:  # the parameters come as the modules store them, f32
        w1 = w1.bfloat16()
    with pytest.raises(ValueError):
        token_cuda.token_mix_block(x, s, b, w1, b1, w2, b2)


def test_token_mix_block_refuses_a_non_contiguous_x_for_the_kernel(monkeypatch):
    """Where the kernel would be taken, a non-contiguous x raises before any
    launch (no copy, no fall back to the plain version)."""
    norm, token, x = _token_half(torch.bfloat16, S=8, D=512)
    monkeypatch.setattr(token_cuda, "takes_kernel", lambda args: True)
    monkeypatch.setattr(token_cuda, "_kernel", lambda: pytest.fail("launched the kernel"))
    monkeypatch.setattr(token_cuda, "token_mix_reference",
                        lambda *a: pytest.fail("fell back to the plain version"))
    strided = torch.cat([x, x], -1)[..., ::2]
    assert strided.shape == x.shape and not strided.is_contiguous()
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        token_cuda.token_mix_block(strided, *_token_params(norm, token))


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_token_mix_block_hands_the_kernel_its_arguments(dtype, code, monkeypatch):
    """The C entry gets the seven inputs' and the output's pointers, then P,
    S, hidden, D, the dtype code, the device index and the stream, and the
    call counts one launch."""
    norm, token, x = _token_half(dtype, P=3, S=8, D=512)
    params = tuple(p.detach() for p in _token_params(norm, token))
    calls = []

    def entry(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(token_cuda, "takes_kernel", lambda args: True)
    monkeypatch.setattr(token_cuda, "_kernel", lambda: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(
        cuda_stream=7))
    before = token_cuda.launches, token_cuda.plain_calls
    y = token_cuda.token_mix_block(x, *params)
    (a,) = calls
    assert a[:7] == tuple(t.data_ptr() for t in (x,) + params) and a[7] == y.data_ptr()
    assert a[8:] == (3, 8, 32, 512, code, None, 7)  # a CPU tensor's device index, the stream
    assert y.shape == x.shape and y.dtype == dtype
    assert (token_cuda.launches, token_cuda.plain_calls) == (before[0] + 1, before[1])
    entry_failed = types.SimpleNamespace(n=0)

    def failing(*a):
        entry_failed.n += 1
        return 700

    monkeypatch.setattr(token_cuda, "_kernel", lambda: failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        token_cuda.token_mix_block(x, *params)
    assert entry_failed.n == 1 and token_cuda.launches == before[0] + 1


@pytest.mark.parametrize("depth", [1, 3])
def test_mlp_mixer_runs_each_token_half_through_the_block(depth, monkeypatch):
    """MLPMixer hands each block's token half, with its own parameters, to
    ``token_mix_block``: depth calls a forward; the CPU takes no kernel."""
    seen = []
    real = token_cuda.token_mix_block

    def spy(x, *params):
        seen.append(params)
        return real(x, *params)

    monkeypatch.setattr(mixer, "token_mix_block", spy)
    m = mixer.MLPMixer(8, 40, 32, 24, depth)
    before = token_cuda.launches, token_cuda.plain_calls
    with torch.no_grad():
        m(torch.randn(2, 8, 40))
    assert len(seen) == depth
    for d, params in enumerate(seen):
        norm, token = getattr(m, f"block{d}_token_norm"), getattr(m, f"block{d}_token")
        assert all(a is b for a, b in zip(params, _token_params(norm, token)))
    assert (token_cuda.launches, token_cuda.plain_calls) == before


@pytest.mark.parametrize("case", ["grad recording", "S=16", "float16", "no points"])
def test_token_mix_block_raises_off_the_cpu_where_the_kernel_does_not_serve(case, monkeypatch):
    """Off the CPU the block launches the kernel or raises: a call the kernel
    does not serve (autograd recording, another shape or dtype, no points)
    never runs the plain version. Meta tensors stand in for the card's."""
    S, P, dtype = 8, 4, torch.bfloat16
    if case == "S=16":
        S = 16
    elif case == "float16":
        dtype = torch.float16
    elif case == "no points":
        P = 0
    norm, token, x = _token_half(dtype, P=P, S=S, D=512)
    params = [t.detach().to("meta") for t in _token_params(norm, token)]
    if case == "grad recording":
        params[2].requires_grad_(True)
    monkeypatch.setattr(token_cuda, "_kernel", lambda: pytest.fail("launched the kernel"))
    monkeypatch.setattr(token_cuda, "token_mix_reference",
                        lambda *a: pytest.fail("ran the plain version"))
    want = "autograd recording" if case == "grad recording" else "autograd off"
    with pytest.raises(ValueError, match=f"{want}: call token_mix_reference"):
        token_cuda.token_mix_block(x.to("meta"), *params)


@pytest.mark.parametrize("serves", [False, True])
def test_mlp_mixer_calls_the_plain_version_by_name_off_the_cpu(serves, monkeypatch):
    """Off the CPU the mixer asks ``takes_kernel`` about each token half's
    own arguments: where the kernel serves it, ``token_mix_block`` computes
    it; elsewhere the mixer calls ``token_mix_reference`` by name and counts
    it in ``plain_calls``, so the block never falls back. Meta tensors stand
    in for the card's."""
    depth = 3
    m = mixer.MLPMixer(8, 40, 32, 24, depth).to("meta")
    asked, blocks, plain = [], [], []
    real = token_cuda.token_mix_reference

    def takes(args):
        asked.append(args)
        return serves

    def block(*args):
        blocks.append(args)
        return real(*args)

    def reference(*args):
        plain.append(args)
        return real(*args)

    monkeypatch.setattr(token_cuda, "takes_kernel", takes)
    monkeypatch.setattr(mixer, "token_mix_block", block)
    monkeypatch.setattr(mixer, "token_mix_reference", reference)
    before = token_cuda.launches, token_cuda.plain_calls
    y = m(torch.randn(2, 8, 40, device="meta"))
    assert y.shape == (2, 24) and y.device.type == "meta"
    assert len(asked) == depth and (len(blocks), len(plain)) == ((depth, 0) if serves else
                                                                 (0, depth))
    for d, args in enumerate(asked):
        norm, token = getattr(m, f"block{d}_token_norm"), getattr(m, f"block{d}_token")
        assert all(a is b for a, b in zip(args[1:], _token_params(norm, token)))
        assert args == (blocks if serves else plain)[d]
    assert (token_cuda.launches, token_cuda.plain_calls) == (before[0],
                                                             before[1] + (0 if serves else depth))


def test_token_kernel_shape_and_entry_are_the_sources():
    """The shape the wrapper sends to the kernel is the one
    ``csrc/token_ff.cu`` is compiled for, and the wrapper types the C
    entry's arguments as the source declares them: eight pointers, six ints
    (points, S, hidden, D, the dtype code, the device), the stream."""
    src = "token_ff.cu"
    S, H, D = token_cuda.KERNEL_SHAPE
    assert (_constexpr(src, "kS"), _constexpr(src, "kH"), _constexpr(src, "kD")) == (S, H, D)
    assert H == 4 * S
    decl = re.search(r"int pips_token_ff\(([^)]*)\)", (_CSRC / src).read_text()).group(1)
    kinds = ["ptr" if "*" in a else a.split()[0] for a in decl.split(",")]
    assert kinds == ["ptr"] * 8 + ["int"] * 6 + ["ptr"]
    assert "if (points <= 0 || S != kS || H != kH || D != kD" in (_CSRC / src).read_text()
