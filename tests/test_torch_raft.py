"""The port's RAFT baseline (``pips_tpu_torch/models/raft.py``), its flow
chain (``inference/flow_chain.py``) and its converter against the JAX
package's, on the CPU, from the same seeded weights written in the layout of
the published ``raft-things.pth`` (``module.`` prefixes, batch-norm
``num_batches_tracked`` and the ``downsample.1`` aliases of ``norm3``).

Tolerances: the converter's leaves exactly; the full-width RAFT's
``flow_low`` and ``flow_up`` within 1e-2 px at 1 and 2 iterations (the JAX
package's own test against the reference's torch RAFT allows 0.05); the
lookup, the pyramid and the convex upsampling within 1e-5; the chained
trajectories within 1e-4 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.inference import flow_chain as jax_flow_chain
from pips_tpu.models import raft as jax_raft
from pips_tpu.torchport.convert import convert_raft_state_dict as jax_convert_raft
from pips_tpu_torch.convert import load_flax_params, state_dict_from_flax
from pips_tpu_torch.inference import FlowChainTracker
from pips_tpu_torch.inference.flow_chain import chain_flows
from pips_tpu_torch.models import raft
from pips_tpu_torch.torchport import convert_raft_state_dict

FLOW_PX = 1e-2
EXACT = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raft_reference_state_dict(seed: int, prefix: str = "module.") -> dict:
    """Seeded RAFT weights (fnet 256, cnet 128+128, 4 levels of radius 4) in
    the published checkpoint's layout: convs He-normal over their fan-in,
    biases and batch-norm parameters and statistics moved off 0 and 1."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, kh, kw):
        sd[f"{name}.weight"] = (rng.randn(o, i, kh, kw) * np.sqrt(2.0 / (i * kh * kw))
                                ).astype(np.float32)
        sd[f"{name}.bias"] = (0.05 * rng.randn(o)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.05 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (0.5 + rng.rand(c)).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(100000, np.int64)

    for enc, batch in (("fnet", False), ("cnet", True)):
        conv(f"{enc}.conv1", 64, 3, 7, 7)
        if batch:
            bn(f"{enc}.norm1", 64)
        c_in = 64
        for stage, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)], 1):
            for blk in (0, 1):
                s, ci = (stride, c_in) if blk == 0 else (1, dim)
                p = f"{enc}.layer{stage}.{blk}"
                conv(f"{p}.conv1", dim, ci, 3, 3)
                conv(f"{p}.conv2", dim, dim, 3, 3)
                if batch:
                    bn(f"{p}.norm1", dim)
                    bn(f"{p}.norm2", dim)
                if s != 1:
                    conv(f"{p}.downsample.0", dim, ci, 1, 1)
                    if batch:
                        bn(f"{p}.norm3", dim)
                        for k in [k for k in sd if k.startswith(f"{p}.norm3.")]:
                            sd[k.replace(".norm3.", ".downsample.1.")] = sd[k]
            c_in = dim
        conv(f"{enc}.conv2", 256, 128, 1, 1)
    u = "update_block"
    conv(f"{u}.encoder.convc1", 256, 4 * 81, 1, 1)
    conv(f"{u}.encoder.convc2", 192, 256, 3, 3)
    conv(f"{u}.encoder.convf1", 128, 2, 7, 7)
    conv(f"{u}.encoder.convf2", 64, 128, 3, 3)
    conv(f"{u}.encoder.conv", 126, 256, 3, 3)
    for gate in "zrq":
        conv(f"{u}.gru.conv{gate}1", 128, 384, 1, 5)
        conv(f"{u}.gru.conv{gate}2", 128, 384, 5, 1)
    conv(f"{u}.flow_head.conv1", 256, 128, 3, 3)
    conv(f"{u}.flow_head.conv2", 2, 256, 3, 3)
    conv(f"{u}.mask.0", 256, 128, 3, 3)
    conv(f"{u}.mask.2", 64 * 9, 256, 1, 1)
    return {prefix + k: v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _weights():
    sd = raft_reference_state_dict(0)
    return sd, jax_convert_raft(sd)


@functools.lru_cache(maxsize=None)
def _port_raft():
    return load_flax_params(raft.RAFT(), convert_raft_state_dict(_weights()[0])).eval()


@functools.lru_cache(maxsize=None)
def _jax_raft(iters: int):
    return jax.jit(lambda v, a, b: jax_raft.RAFT().apply(v, a, b, iters=iters))


def _frames(H: int, W: int, seed: int = 1):
    """Two frames in [0, 255], the second the first shifted 3 px right plus noise."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(1, H, W, 3) * 255).astype(np.float32)
    b = np.clip(np.roll(a, 3, axis=2) + rng.randn(1, H, W, 3).astype(np.float32) * 10, 0, 255)
    return a, b.astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("prefix", ["module.", "model.module.", ""])
def test_raft_converter_equals_jax_leaf_for_leaf(prefix):
    sd = raft_reference_state_dict(3, prefix)
    got, want = list(_flat(convert_raft_state_dict(sd))), list(_flat(jax_convert_raft(sd)))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert {k[0] for k, _ in got} == {"params", "batch_stats"}
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_raft_load_holds_the_converted_leaves_bit_for_bit():
    """Every leaf lands in the port's RAFT once, the batch statistics as the
    norms' ``mean``/``var`` buffers; a wrong shape raises."""
    variables = convert_raft_state_dict(_weights()[0])
    model = _port_raft()
    own = model.state_dict()
    want = state_dict_from_flax(variables)
    assert sorted(own) == sorted(want)
    assert "cnet.layer2_0.norm3.mean" in own and "update_block.gru.convz1.kernel" in own
    for k, v in want.items():
        np.testing.assert_array_equal(own[k].numpy(), v, err_msg=k)
    bad = jax.tree.map(np.copy, variables)
    bad["batch_stats"]["cnet"]["norm1"]["var"] = np.ones(65, np.float32)
    with pytest.raises(ValueError, match="cnet.norm1.var"):
        load_flax_params(raft.RAFT(), bad)


@pytest.mark.parametrize("iters", [1, 2])
def test_raft_matches_jax(iters):
    """Full-width RAFT at 128x160 (every pyramid level at least 2x2)."""
    a, b = _frames(128, 160)
    flow_low, flow_up = _jax_raft(iters)(_weights()[1], jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        low, up = _port_raft()(torch.from_numpy(a), torch.from_numpy(b), iters=iters)
    assert low.shape == (1, 16, 20, 2) and up.shape == (1, 128, 160, 2)
    assert np.abs(np.asarray(flow_up)).max() > 1.0  # the flows are not trivially small
    np.testing.assert_allclose(low.numpy(), np.asarray(flow_low), rtol=0, atol=FLOW_PX)
    np.testing.assert_allclose(up.numpy(), np.asarray(flow_up), rtol=0, atol=FLOW_PX)


def _pyramids(H=9, W=12, C=16, seed=4):
    rng = np.random.RandomState(seed)
    f1, f2 = (rng.randn(2, H, W, C).astype(np.float32) for _ in range(2))
    want = jax_raft.allpairs_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = raft.allpairs_corr_pyramid(torch.from_numpy(f1).permute(0, 3, 1, 2),
                                     torch.from_numpy(f2).permute(0, 3, 1, 2), 4)
    return got, want


def test_allpairs_corr_pyramid_matches_jax():
    """Odd sizes (9x12 -> 4x6 -> 2x3 -> 1x1): the pooling floors as JAX's."""
    got, want = _pyramids()
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=EXACT)


def test_corr_lookup_patch_order_matches_jax():
    """The (2r+1)^2 patch comes out i-major over x offsets, as JAX (and the
    reference) order it; coordinates off the map read zero taps. The
    transposed order is far from JAX's, so the check has teeth."""
    got_pyr, want_pyr = _pyramids()
    rng = np.random.RandomState(5)
    coords = (rng.rand(2, 9, 12, 2) * [16, 13] - [2, 2]).astype(np.float32)
    want = np.asarray(jax_raft.corr_lookup(want_pyr, jnp.asarray(coords), 2))
    got = raft.corr_lookup(got_pyr, torch.from_numpy(coords), 2).numpy()
    assert got.shape == want.shape == (2, 9, 12, 4 * 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    swapped = got.reshape(2, 9, 12, 4, 5, 5).swapaxes(-1, -2).reshape(got.shape)
    assert np.abs(swapped - want).max() > 0.1


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(6)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    mask = rng.randn(2, 5, 7, 576).astype(np.float32)
    want = np.asarray(jax_raft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = raft.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)


def test_raftnet_pads_sizes_off_the_grid_of_8():
    """``Raftnet.forward`` on [-0.5, 0.5] frames of 66x90: edge-replicated to
    72x96, cropped back, within the flow tolerance of JAX's wrapper."""
    a, b = _frames(66, 90, seed=2)
    a, b = a / 255.0 - 0.5, b / 255.0 - 0.5
    want = jax_raft.Raftnet(_weights()[1], iters=1).forward(a, b)
    got = raft.Raftnet(_port_raft(), iters=1, device="cpu").forward(a, b)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (1, 66, 90, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOW_PX)


def test_chain_flows_matches_jax():
    """Border-replicating sampling of each flow at the point's current
    position, points starting inside and off the frame."""
    rng = np.random.RandomState(7)
    flows = (rng.randn(2, 5, 12, 16, 2) * 3).astype(np.float32)
    xy0 = (rng.rand(2, 9, 2) * [20, 16] - [2, 2]).astype(np.float32)
    want = np.asarray(jax_flow_chain.chain_flows(jnp.asarray(flows), jnp.asarray(xy0)))
    got = chain_flows(torch.from_numpy(flows), torch.from_numpy(xy0)).numpy()
    assert got.shape == want.shape == (2, 6, 9, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_flow_chain_tracker_matches_jax():
    """Numpy in and out; the flow fn sees the frames in [-0.5, 0.5] on the
    tracker's device and its flows stay there."""
    rng = np.random.RandomState(8)
    rgbs = (rng.rand(1, 5, 12, 16, 3) * 255).astype(np.float32)
    xy0 = (rng.rand(1, 7, 2) * [15, 11]).astype(np.float32)
    seen = []

    def port_flow(a, b):
        seen.append((a.device.type, float(a.min()), float(a.max())))
        return 4.0 * (b - a)[..., :2] + torch.tensor([1.5, -0.5])

    def jax_flow(a, b):
        return 4.0 * (b - a)[..., :2] + np.array([1.5, -0.5], np.float32)

    want = jax_flow_chain.FlowChainTracker(jax_flow).track(rgbs, xy0)
    got = FlowChainTracker(port_flow, device="cpu").track(rgbs, xy0)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (1, 5, 7, 2)
    np.testing.assert_array_equal(got[:, 0], xy0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(seen) == 4 and all(d == "cpu" and lo >= -0.5 and hi <= 0.5 for d, lo, hi in seen)


def test_profile_baselines_runs_on_the_cpu():
    """The baselines' profiling tool at a small size: every time finite and
    positive, both cuDNN settings."""
    from pips_tpu_torch import profile_baselines

    out = profile_baselines.main(hw=(64, 96), iters=1, reps=1, device="cpu")
    secs = out["seconds"]
    assert len(secs) == 6 and all(np.isfinite(v) and v > 0 for v in secs.values()), out
    assert "raft pair, 1 iters, cudnn tf32 False" in secs


@pytest.mark.parametrize("wrap", [False, True])
def test_load_raft_state_dict_reads_the_release_layout(tmp_path, wrap):
    """A bare state dict (as ``raft-things.pth``) or one under
    ``"model_state_dict"``, back as the same numpy arrays."""
    from pips_tpu_torch.evals import common

    sd = raft_reference_state_dict(4)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"model_state_dict": tensors} if wrap else tensors, tmp_path / "raft.pth")
    got = common.load_raft_state_dict(str(tmp_path / "raft.pth"))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v, err_msg=k)
