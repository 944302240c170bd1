"""The port's eval support (``pips_tpu_torch/torchport``, ``evals/common.py``,
``evals/metrics.py``, ``utils/improc.py``, ``utils/format.py``,
``utils/saverloader.load_raw`` and ``ops/embed.py``) against the JAX
package's, on the same numpy inputs.

Weights come in the reference's own checkpoint layout (``model-*.pth``),
built here from a seeded TINY state dict: the key map must give JAX's leaves
exactly, and the model it loads must give JAX's trajectories within 1e-4 px
at one refinement iteration in f32 (given JAX's time steps; see
``test_reference_pth_forward_equals_jax_load_params``). Metrics agree within 1e-6, the
half-pixel resize within 1e-3 levels on [0, 255] frames, the embeddings
within 1e-6 and every drawing function exactly (the same cv2 draws both).
"""

import contextlib
import functools
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pips_tpu.evals import common as jax_common
from pips_tpu.evals import metrics as jax_metrics
from pips_tpu.models import Pips as JaxPips
from pips_tpu.ops import embed as jax_embed
from pips_tpu.torchport import convert as jax_torchport
from pips_tpu.utils import format as jax_format
from pips_tpu.utils import improc as jax_improc
from pips_tpu.utils.logging import MetricWriter as JaxMetricWriter
from pips_tpu_torch.evals import common, metrics
from pips_tpu_torch.models.pips import Pips, init_params
from pips_tpu_torch.ops import embed
from pips_tpu_torch.torchport import convert as torchport
from pips_tpu_torch.utils import format as port_format
from pips_tpu_torch.utils import flax_msgpack, improc, saverloader
from pips_tpu_torch.utils.logging import MetricWriter

TINY = dict(latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32, mixer_depth=2)


# --- the reference checkpoint layout ---------------------------------------

def reference_key(key: str, a: np.ndarray, depth: int) -> tuple[str, np.ndarray]:
    """The port's state-dict entry -> the reference model's (``nets/pips.py``)
    name and layout: the inverse of the key map under test."""
    mods = key.split(".")
    if mods[0] == "fnet":
        m = re.fullmatch(r"layer(\d)_(\d)", mods[1])
        if m:
            mods[1:2] = [f"layer{m[1]}", m[2]]
        if "downsample" in mods:
            mods.insert(mods.index("downsample") + 1, "0")
        return ".".join(mods), a
    *path, leaf = mods
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    if leaf == "weight" and mods[-1] == "kernel":
        a = np.ascontiguousarray(a.T)
    if path[0] == "delta_block":
        name, rest = path[2], path[3:]
        m = re.fullmatch(r"block(\d+)_(token|chan)(_norm)?", name)
        if m:
            d, part, norm = int(m[1]), m[2], m[3]
            sub = "0" if part == "token" else "1"
            if norm:
                return f"delta_block.to_delta.{d + 1}.{sub}.norm.{leaf}", a
            fc = {"fc1": "0", "fc2": "3"}[rest[0]]
            if part == "token" and leaf == "weight":
                a = a[:, :, None]  # Conv1d, kernel size 1
            return f"delta_block.to_delta.{d + 1}.{sub}.fn.{fc}.{leaf}", a
        idx = {"embed": 0, "final_norm": depth + 1, "head": depth + 3}[name]
        return f"delta_block.to_delta.{idx}.{leaf}", a
    top = {"ffeat_norm": "norm", "ffeat_updater": "ffeat_updater.0",
           "vis_predictor": "vis_predictor.0"}[path[0]]
    return f"{top}.{leaf}", a


def seeded_state_dict(seed: int, S: int = 8, stride: int = 8) -> dict:
    """A TINY port state dict with every entry drawn from the seed: weights
    over their fan-in, biases and norm scales off 0 and 1, so that a
    swapped or misplaced leaf shows."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in Pips(S=S, stride=stride, **TINY).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith(".kernel"):
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif k.endswith(".scale"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = a.astype(np.float32)
    return sd


def write_reference_pth(path, sd: dict, prefix: str = "", wrap: bool = True) -> str:
    """Write ``sd`` (the port's names) as a reference ``model-*.pth``."""
    depth = TINY["mixer_depth"]
    ref = dict(reference_key(k, a, depth) for k, a in sd.items())
    ref = {prefix + k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in ref.items()}
    torch.save({"model_state_dict": ref, "optimizer_state_dict": {}} if wrap else ref, str(path))
    return str(path)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("prefix,wrap", [("", True), ("module.", True), ("", False),
                                         ("module.", False)])
def test_key_map_equals_jax_leaf_for_leaf(tmp_path, prefix, wrap):
    pth = write_reference_pth(tmp_path / "model-000000001.pth", seeded_state_dict(1), prefix,
                              wrap)
    got = dict(_flat(torchport.load_torch_checkpoint(pth, mixer_depth=2)))
    want = dict(_flat(jax_torchport.load_torch_checkpoint(pth, mixer_depth=2)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    ref_sd = torch.load(pth, weights_only=True)
    ref_sd = ref_sd.get("model_state_dict", ref_sd)
    np.testing.assert_array_equal(
        torchport.convert_pips_state_dict({k.removeprefix("module."): v.numpy()
                                           for k, v in ref_sd.items()}, mixer_depth=2)
        ["vis_predictor"]["kernel"], want[("vis_predictor", "kernel")])


def test_load_params_reference_pth_round_trips_bit_for_bit(tmp_path):
    sd = seeded_state_dict(2)
    pth = write_reference_pth(tmp_path / "model-000000002.pth", sd, "module.")
    for src in (pth, str(tmp_path)):  # the file, and a directory of them
        model = common.load_params(Pips(S=8, stride=8, **TINY), src)
        got = model.state_dict()
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@functools.lru_cache(maxsize=None)
def _forward_inputs():
    rng = np.random.RandomState(3)
    rgbs = (rng.rand(1, 8, 64, 96, 3) * 255).astype(np.float32)
    xys = (rng.rand(1, 8, 2) * [88, 56] + 4).astype(np.float32)
    return rgbs, xys


@functools.lru_cache(maxsize=None)
def _jax_forward(pth: str):
    rgbs, xys = _forward_inputs()
    model = JaxPips(S=8, stride=8, **TINY)
    params = jax_common.load_params(model, pth)
    out = model.apply(params, jnp.asarray(xys), jnp.asarray(rgbs), iters=1, is_train=False)
    return np.asarray(out.coord_predictions[-1]), np.asarray(out.vis_e)


@pytest.fixture(scope="module")
def ref_pth(tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    return write_reference_pth(d / "model-000000003.pth", seeded_state_dict(3), "module.")


@pytest.mark.parametrize("times,tol", [("jax", 1e-4), ("own", 1e-3)])
def test_reference_pth_forward_equals_jax_load_params(ref_pth, monkeypatch, times, tol):
    """One f32 iteration from the same ``.pth`` through each package's
    ``load_params``. The mixer embeds the window's time steps
    ``linspace(0, S, S)`` at frequencies up to 969, and ``jnp.linspace``
    and ``torch.linspace`` differ by an ulp at t = 32/7 and 48/7 (4.8e-7),
    which moves the trajectories by up to 4.4e-4 px (measured). Given
    JAX's time steps the port agrees within 1e-4 px (measured 2.3e-5); with
    its own, the reference's ``torch.linspace``, within 1e-3."""
    pth = ref_pth
    want, want_vis = _jax_forward(pth)
    if times == "jax":
        monkeypatch.setattr(torch, "linspace", lambda a, b, n, **kw: torch.from_numpy(
            np.asarray(jnp.linspace(a, b, n))).to(kw.get("device")))
    rgbs, xys = _forward_inputs()
    model = common.load_params(Pips(S=8, stride=8, **TINY), pth).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=1)
    got = out.coord_predictions[-1].numpy()
    assert np.abs(want - xys[:, None]).max() > 1.0  # the points moved
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(out.vis_e.numpy(), want_vis, atol=tol, rtol=0)


@pytest.mark.parametrize("payload", ["train_loop", "bare"])
def test_load_params_port_checkpoint_reloads_bit_equal(tmp_path, payload):
    src = init_params(Pips(S=8, stride=8, **TINY), 5)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01 * torch.randn_like(p))
    sd = src.state_dict()
    tree = {"model": sd, "optimizer": {"state": {}, "param_groups": []}} \
        if payload == "train_loop" else sd
    saverloader.save(str(tmp_path), tree, 7)
    saverloader.save(str(tmp_path), tree, 9, keep_latest=0)
    raw, step = saverloader.load_raw(str(tmp_path))
    assert step == 9 and sorted(raw) == sorted(tree)
    assert saverloader.load_raw(str(tmp_path), step=7)[1] == 7
    model = common.load_params(Pips(S=8, stride=8, **TINY), str(tmp_path))
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_load_params_raises_with_guidance(tmp_path):
    with pytest.raises(FileNotFoundError, match="expected model-"):
        common.load_params(Pips(S=8, stride=8, **TINY), str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        saverloader.load_raw(str(tmp_path))
    (tmp_path / "model-000000001.msgpack").write_bytes(b"")  # an empty JAX checkpoint
    with pytest.raises(flax_msgpack.DecodeError, match="truncated"):
        common.load_params(Pips(S=8, stride=8, **TINY), str(tmp_path))
    other = tmp_path / "other"
    saverloader.save(str(other), {"model": {"fnet.conv1.weight": torch.zeros(1)}}, 1)
    with pytest.raises(RuntimeError, match="Missing key"):
        common.load_params(Pips(S=8, stride=8, **TINY), str(other))


def test_load_params_random_is_init_params_seed_0(capsys):
    model = common.load_params(Pips(S=8, stride=8, **TINY), "random")
    assert "randomly initialized" in capsys.readouterr().out
    want = init_params(Pips(S=8, stride=8, **TINY), 0).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("dtype,want", [("float32", None), ("bfloat16", torch.bfloat16),
                                        ("bf16", torch.bfloat16)])
def test_make_pips_turns_the_kernel_on_for_bf16_on_cuda(monkeypatch, dtype, want):
    asked = []

    def fuse(flag, dt, device):
        asked.append((flag, dt, device.type))
        return dt is not None  # as on the card

    monkeypatch.setattr(common, "Pips", lambda **kw: Pips(**kw, **TINY))
    monkeypatch.setattr(common, "resolve_fuse_chanff", fuse)
    model = common.make_pips(S=8, stride=4, dtype=dtype, device="cpu")
    assert asked == [(-1, want, "cpu")]
    assert model.delta_block.to_delta.fuse_chanff == (want is not None)
    assert model.stride == 4 and not model.training


# --- metrics, resizing, embeddings -----------------------------------------

def test_metrics_equal_jax():
    rng = np.random.RandomState(4)
    e, g = rng.rand(2, 8, 16, 2) * 50, rng.rand(2, 8, 16, 2) * 50
    vis = (rng.rand(2, 8, 16) < 0.7).astype(np.float32)
    valids = (rng.rand(2, 8, 16) < 0.9).astype(np.float32)
    np.testing.assert_array_equal(metrics.per_seq_vis_label(vis, 4),
                                  jax_metrics.per_seq_vis_label(vis, 4))
    got = metrics.ate_metrics(e, g, valids, vis)
    want = jax_metrics.ate_metrics(e, g, valids, vis)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    segs = (rng.rand(8, 40, 60) < 0.3).astype(np.float32)
    got = metrics.pck_at_sqrt_area(e[0] / 5, g[0] / 5, vis[0], segs)
    assert abs(got - jax_metrics.pck_at_sqrt_area(e[0] / 5, g[0] / 5, vis[0], segs)) <= 1e-6
    assert np.isnan(metrics.pck_at_sqrt_area(e[0], g[0], 0 * vis[0], segs))


@pytest.mark.parametrize("hw,out_hw", [((540, 960), (320, 512)), ((1080, 1920), (480, 1024)),
                                       ((64, 96), (128, 160)), ((96, 64), (48, 160))])
def test_resize_video_half_pixel_equals_jax_image_resize(hw, out_hw):
    """jax.image.resize antialiases where it shrinks; the port must too."""
    x = (np.random.RandomState(hw[0]).rand(2, *hw, 3) * 255).astype(np.float32)
    got = common.resize_video_half_pixel(x, out_hw)
    want = jax_common.resize_video_half_pixel(x, out_hw)
    assert got.shape == want.shape == (2, *out_hw, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-3


def test_resize_video_nearest_equals_jax():
    x = np.random.RandomState(5).rand(3, 60, 80).astype(np.float32)
    for out_hw in ((32, 48), (120, 100)):
        np.testing.assert_array_equal(common.resize_video_nearest(x, out_hw),
                                      jax_common.resize_video_nearest(x, out_hw))


def test_posemb_equal_jax():
    rng = np.random.RandomState(6)
    x, y = rng.randn(2, 5).astype(np.float32) * 30, rng.randn(2, 5).astype(np.float32) * 30
    np.testing.assert_allclose(
        embed.posemb_sincos_2d_xy(torch.from_numpy(x), torch.from_numpy(y), dim=64).numpy(),
        np.asarray(jax_embed.posemb_sincos_2d_xy(jnp.asarray(x), jnp.asarray(y), dim=64)),
        atol=1e-6, rtol=0)
    xyz = rng.randn(2, 7, 3).astype(np.float32) * 10
    for cat in (False, True):
        np.testing.assert_allclose(
            embed.posemb_sincos_3d(torch.from_numpy(xyz), dim=32, cat_coords=cat).numpy(),
            np.asarray(jax_embed.posemb_sincos_3d(jnp.asarray(xyz), dim=32, cat_coords=cat)),
            atol=1e-6, rtol=0)
    from pips_tpu_torch import ops
    assert ops.posemb_sincos_2d_xy is embed.posemb_sincos_2d_xy
    assert ops.posemb_sincos_3d is embed.posemb_sincos_3d


# --- improc and format -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _media_inputs():
    rng = np.random.RandomState(7)
    S, N, H, W = 4, 5, 48, 64
    rgbs = (rng.rand(S, H, W, 3) * 255).astype(np.uint8)
    trajs = (rng.rand(S, N, 2) * [W - 1, H - 1]).astype(np.float32)
    return dict(
        rgb=rgbs[0], rgbs=rgbs, rgbf=improc.preprocess_color(rgbs[0]),
        rgbsf=improc.preprocess_color(rgbs), trajs=trajs,
        valids=(rng.rand(S, N) < 0.8).astype(np.float32),
        vis=(rng.rand(S, N) < 0.6).astype(np.float32),
        feat=rng.randn(12, 16, 8).astype(np.float32),
        feats=rng.randn(3, 12, 16, 8).astype(np.float32),
        seg=rng.rand(N, H, W).astype(np.float32),
        colors=(rng.rand(N, 3) * 255).astype(np.uint8),
        x=rng.randn(H, W).astype(np.float32), xs=rng.randn(3, H, W).astype(np.float32),
        fcps=rng.rand(2, 3, 6, 8).astype(np.float32),
        coords=(rng.rand(3, 2, 2) * [60, 44]).astype(np.float32),
        traj_g=(rng.rand(2, 2) * [60, 44]).astype(np.float32),
        u=rng.rand(H, W).astype(np.float32), v=rng.rand(H, W).astype(np.float32),
        seq=rng.rand(S, 12, 16).astype(np.float32),
        xys=(rng.rand(N, 2) * [W, H]).astype(np.float32),
        flow=(rng.randn(H, W, 2) * 20).astype(np.float32),
        flows=(rng.randn(3, H, W, 2) * 20).astype(np.float32))


IMPROC_CASES = {
    "preprocess_color": lambda m, d: m.preprocess_color(d["rgbs"]),
    "back2color": lambda m, d: m.back2color(d["rgbsf"]),
    "draw_frame_id_on_vis": lambda m, d: m.draw_frame_id_on_vis(d["rgb"], 0.25),
    "draw_trajs_on_rgb": lambda m, d: m.draw_trajs_on_rgb(d["rgb"], d["trajs"], d["valids"]),
    "draw_trajs_on_rgbs": lambda m, d: m.draw_trajs_on_rgbs(d["rgbs"], d["trajs"], d["vis"]),
    "draw_trajs_on_rgbs2": lambda m, d: m.draw_trajs_on_rgbs2(d["rgbs"], d["trajs"], d["vis"],
                                                              linewidth=2),
    "pca_feat_vis": lambda m, d: m.pca_feat_vis(d["feat"]),
    "oned_to_rgb": lambda m, d: m.oned_to_rgb(d["x"]),
    "draw_circles_at_xy": lambda m, d: m.draw_circles_at_xy(d["xys"], 48, 64, sigma=3.0),
    "render_fcp_vis": lambda m, d: m.render_fcp_vis(d["fcps"], d["coords"], d["traj_g"]),
    "colormap_2d": lambda m, d: m.colormap_2d(d["u"], d["v"]),
    "seq2color": lambda m, d: m.seq2color(d["seq"]),
    "flow2color": lambda m, d: m.flow2color(d["flows"]),
    "flow2color clip 0": lambda m, d: m.flow2color(d["flows"], clip=0.0),
}

SUMM_CASES = {
    "summ_rgb": lambda sw, d: sw.summ_rgb("a/rgb", d["rgbf"], only_return=True, frame_id=3.5),
    "summ_rgbs": lambda sw, d: sw.summ_rgbs("a/rgbs", list(d["rgbsf"]), only_return=True,
                                            frame_ids=[0, 1, 2, 0.5]),
    "summ_oned": lambda sw, d: sw.summ_oned("a/oned", d["x"], only_return=True, frame_id=1),
    "summ_oneds": lambda sw, d: sw.summ_oneds("a/oneds", list(d["xs"]), norm=False,
                                              only_return=True, frame_ids=[1, 2, 3]),
    "summ_feat": lambda sw, d: sw.summ_feat("a/feat", d["feat"], only_return=True),
    "summ_feats": lambda sw, d: sw.summ_feats("a/feats", list(d["feats"]), only_return=True),
    "summ_traj2ds_on_rgb": lambda sw, d: sw.summ_traj2ds_on_rgb(
        "a/t", d["trajs"], d["rgbf"], valids=d["valids"], cmap="winter", linewidth=2,
        only_return=True, frame_id=4.25),
    "summ_traj2ds_on_rgbs": lambda sw, d: sw.summ_traj2ds_on_rgbs(
        "a/ts", d["trajs"], d["rgbsf"], visibles=d["vis"], only_return=True,
        frame_ids=[0, 1, 2, 3]),
    "summ_traj2ds_on_rgbs2": lambda sw, d: sw.summ_traj2ds_on_rgbs2(
        "a/ts2", d["trajs"], d["vis"], d["rgbs"], valids=d["valids"], only_return=True),
    "summ_pts_on_rgbs": lambda sw, d: sw.summ_pts_on_rgbs(
        "a/pts", d["trajs"], d["rgbsf"], valids=d["valids"], only_return=True),
    "summ_soft_seg_thr": lambda sw, d: sw.summ_soft_seg_thr("a/seg", d["seg"], d["colors"],
                                                            only_return=True),
    "summ_soft_seg_thr default colors": lambda sw, d: sw.summ_soft_seg_thr(
        "a/seg", d["seg"], thr=0.3, only_return=True),
    "summ_gif": lambda sw, d: sw.summ_gif("a/gif", d["rgbsf"], only_return=True),
    "summ_flow": lambda sw, d: sw.summ_flow("a/flow", d["flow"], only_return=True, frame_id=2),
    "summ_flows": lambda sw, d: sw.summ_flows("a/flows", list(d["flows"]), clip=30.0,
                                              only_return=True),
}


@pytest.mark.parametrize("name", sorted(IMPROC_CASES))
def test_improc_function_equals_jax(name):
    d = _media_inputs()
    got, want = IMPROC_CASES[name](improc, d), IMPROC_CASES[name](jax_improc, d)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _writers(tmp_path, step=10, **kw):
    port = improc.Summ_writer(MetricWriter(str(tmp_path / "port"), use_tensorboard=False),
                              step, **kw)
    ref = jax_improc.Summ_writer(JaxMetricWriter(str(tmp_path / "jax"), use_tensorboard=False),
                                 step, **kw)
    return port, ref


def _scalar_records(writer) -> list:
    """The scalars a writer's MetricWriter wrote, without their wall times."""
    with open(writer.writer.path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.mark.parametrize("step, kw", [(5, dict(scalar_freq=5)), (6, dict(scalar_freq=5)),
                                      (10, {}), (15, {}), (4, dict(scalar_freq=2)),
                                      (3, dict(scalar_freq=0))])
def test_summ_writer_scalar_freq_equals_jax(tmp_path, step, kw):
    """``summ_scalar`` writes at the writer's own ``scalar_freq`` (JAX's
    default 10), at JAX's steps: at step 5 with ``scalar_freq=5`` what JAX
    writes, at step 6 nothing; ``just_gif`` is taken and kept, as JAX keeps it."""
    port, ref = _writers(tmp_path, step, log_freq=1, just_gif=False, **kw)
    for sw in (port, ref):
        sw.summ_scalar("a", 1.0)
        sw.writer.close()
    got, want = _scalar_records(port), _scalar_records(ref)
    assert got == want
    assert bool(got) == (step % max(kw.get("scalar_freq", 10), 1) == 0)
    assert (port.scalar_freq, port.just_gif) == (ref.scalar_freq, ref.just_gif)


def test_package_exports_equal_jax():
    """Every name the JAX package exports is an attribute of the port, and
    the two versions are one string."""
    import pips_tpu
    import pips_tpu_torch

    missing = [n for n in pips_tpu.__all__ if not hasattr(pips_tpu_torch, n)]
    assert not missing, missing
    assert set(pips_tpu.__all__) <= set(pips_tpu_torch.__all__)
    assert pips_tpu_torch.__version__ == pips_tpu.__version__ == "0.1.0"
    assert pips_tpu_torch.FlowChainTracker.__module__ == "pips_tpu_torch.inference.flow_chain"


@pytest.mark.parametrize("name", sorted(SUMM_CASES))
def test_summ_writer_method_equals_jax(tmp_path, name):
    port, ref = _writers(tmp_path, log_freq=5)
    d = _media_inputs()
    got, want = SUMM_CASES[name](port, d), SUMM_CASES[name](ref, d)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not (tmp_path / "port" / "media").exists()  # only_return writes nothing


def _media_files(root) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix in (".png", ".gif"):
            with Image.open(p) as im:
                frames = []
                for i in range(getattr(im, "n_frames", 1)):
                    im.seek(i)
                    frames.append(np.array(im.convert("RGB")))
            out[str(p.relative_to(root))] = np.stack(frames)
    return out


def test_summ_writer_files_and_scalars_equal_jax(tmp_path):
    port, ref = _writers(tmp_path, step=20, log_freq=10)
    assert port.save_this and ref.save_this
    d = _media_inputs()
    for sw in (port, ref):
        sw.summ_scalar("loss", 1.5)
        sw.summ_rgb("inputs/rgb", d["rgbf"], frame_id=0.5)
        sw.summ_traj2ds_on_rgbs2("outputs/ts2", d["trajs"], d["vis"], d["rgbsf"])
        sw.summ_gif("outputs/gif", d["rgbs"])
        sw.writer.close()
    got, want = _media_files(tmp_path / "port"), _media_files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    import json
    lines = [json.loads((tmp_path / w / "events.jsonl").read_text()) for w in ("port", "jax")]
    assert lines[0]["step"] == lines[1]["step"] == 20 and lines[0]["loss"] == lines[1]["loss"]


def test_emit_eval_media_equals_jax(tmp_path):
    d = _media_inputs()
    rgbs = d["rgbs"].astype(np.float32)
    for pkg, writer in ((common, MetricWriter), (jax_common, JaxMetricWriter)):
        w = writer(str(tmp_path / pkg.__name__.split(".")[0]), use_tensorboard=False)
        pkg.emit_eval_media(w, 3, rgbs, d["trajs"], d["trajs"][::-1].copy(), d["valids"],
                            2.718)
        w.close()
    got = _media_files(tmp_path / "pips_tpu_torch")
    want = _media_files(tmp_path / "pips_tpu")
    assert sorted(got) == sorted(want) == ["media/00000003_inputs_0_all_single_trajs_on_rgb.png",
                                           "media/00000003_outputs_trajs_on_rgbs.gif"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("x", [0.5, -0.25, 3.0, 12.5, 1e-7, -3.75, 0.0])
def test_format_helpers_equal_jax(x):
    assert port_format.strnum(x) == jax_format.strnum(x)
    assert improc.strnum(x) == jax_improc.strnum(x)
    lr = abs(x) * 1e-4 + 1e-6
    assert port_format.get_lr_str(lr) == jax_format.get_lr_str(lr)
    a = np.random.RandomState(8).randn(3, 4) * (x + 1)
    outs = []
    for fn, arg in ((port_format.print_stats, torch.from_numpy(a)),
                    (jax_format.print_stats, a)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn("t", arg)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
