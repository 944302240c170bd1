"""The port's eval runners (``pips_tpu_torch.evals.run_{flt,crohd,badja,
davis}``) against the JAX package's, end to end on the synthetic trees of
``tests/tests_treeutil.py`` and the same reference-format ``.pth``.

Both packages build the TINY model of ``tests/test_eval_runners.py`` (the
runners' ``Pips`` patched, as that file patches JAX's), run f32 with one
refinement iteration, and the port runs on the CPU. Each JAX runner compiles
once a case. Held: pooled ATEs within 1e-3 px, BADJA's PCK within one
keypoint's share of it, DAVIS's dense trajectories within 1e-3 px, and the
same media files (names, frame counts and sizes). One iteration differs by
at most ~4.4e-4 px, from the time steps' linspace (see
``tests/test_torch_evals.py``).

The RAFT and DINO baselines (``--modeltype raft|dino``) run in both packages
from the same seeded weights in the release files' layouts, RAFT at one
iteration: pooled ATEs within ``BASELINE_ATE_PX`` = 1e-3 px, BADJA's PCK
within one keypoint's share, the same media.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_evals import TINY, seeded_state_dict, write_reference_pth
from tests_treeutil import (make_badja_tree, make_crohd_tree, make_davis_tree,
                            make_flyingthings_tree)

from pips_tpu.evals import common as jax_common
from pips_tpu.evals import run_badja as jax_badja
from pips_tpu.evals import run_crohd as jax_crohd
from pips_tpu.evals import run_davis as jax_davis
from pips_tpu.evals import run_flt as jax_flt
from pips_tpu.models import Pips as JaxPips
from pips_tpu_torch.evals import common, run_badja, run_crohd, run_davis, run_flt
from pips_tpu_torch.models.pips import Pips

ATE_PX = 1e-3
TRAJ_PX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test worker (see tests/test_torch_chain.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tiny_models(monkeypatch):
    monkeypatch.setattr(jax_common, "Pips",
                        lambda S=8, stride=8, **kw: JaxPips(S=S, stride=stride, **TINY))
    monkeypatch.setattr(common, "Pips", lambda S=8, stride=8, dtype=None, fuse_chanff=False:
                        Pips(S=S, stride=stride, dtype=dtype, fuse_chanff=fuse_chanff, **TINY))


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return write_reference_pth(d / "model-000200000.pth", seeded_state_dict(11), "module.")


def media(root) -> dict:
    """Every .png and .gif under ``root``: relative name -> (frames, H, W)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix in (".png", ".gif"):
            with Image.open(p) as im:
                out[str(p.relative_to(root))] = (getattr(im, "n_frames", 1), *im.size[::-1])
    return out


def assert_same_ates(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) == ["ate_all", "ate_occ", "ate_vis"]
    assert np.isfinite(want["ate_all"]) and want["ate_all"] > 0
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= ATE_PX, (k, got[k], want[k])


def test_run_flt_matches_jax(pth, tmp_path_factory):
    root = make_flyingthings_tree(tmp_path_factory.mktemp("flt"), dset="TEST")
    logs = tmp_path_factory.mktemp("flt_logs")
    kw = dict(init_dir=pth, dataset_location=root, N=8, crop_size=(96, 128), max_iters=2,
              iters=1, log_freq=1)
    want = jax_flt.main(**kw, log_dir=str(logs / "jax"))
    got = run_flt.main(**kw, log_dir=str(logs / "port"), device="cpu")
    assert_same_ates(got, want)
    want_media = media(logs / "jax")
    assert media(logs / "port") == want_media
    assert any(k.endswith(".png") for k in want_media)
    assert any(k.endswith(".gif") for k in want_media)


@pytest.mark.parametrize("stride", [8, 4])
def test_run_crohd_matches_jax(pth, tmp_path_factory, stride):
    root = make_crohd_tree(tmp_path_factory.mktemp("ht21"))
    logs = tmp_path_factory.mktemp("crohd_logs")
    kw = dict(init_dir=pth, dataset_root=root, S=8, stride=stride, N=4, iters=1, max_iters=2,
              req_occlusion=False, log_freq=1)
    want = jax_crohd.main(**kw, log_dir=str(logs / "jax"))
    got = run_crohd.main(**kw, log_dir=str(logs / "port"), device="cpu")
    assert_same_ates(got, want)
    want_media = media(logs / "jax")
    assert media(logs / "port") == want_media and len(want_media) == 4


@pytest.mark.parametrize("stride", [8, 4])
def test_run_badja_matches_jax(pth, tmp_path_factory, stride):
    """The whole video through ``ChainTracker`` at 64x96 (at stride 4 the
    feature maps are 16x24), PCK per video and the keypoint GIF."""
    root = make_badja_tree(tmp_path_factory.mktemp("badja"), T=10)
    out = tmp_path_factory.mktemp("badja_out")
    kw = dict(init_dir=pth, data_dir=root, S=8, stride=stride, iters=1, max_iters=1,
              resize_hw=(64, 96))
    want = jax_badja.main(**kw, out_dir=str(out / "jax"))
    got = run_badja.main(**kw, out_dir=str(out / "port"), device="cpu")
    assert sorted(got) == sorted(want) == ["avg", "bear"]
    share = 100.0 / (9 * 20)  # one of the visible keypoints of frames 1..9
    assert np.isfinite(want["avg"])
    assert abs(got["avg"] - want["avg"]) <= share + 1e-9, (got, want)
    assert media(out / "port") == media(out / "jax") == {"bear_kp_vis.gif": (10, 64, 96)}


@pytest.mark.parametrize("chunk", [0, 16])
def test_run_davis_matches_jax(pth, tmp_path_factory, chunk):
    """The dense grid in one call (``--chunk 0``) and in padded chunks."""
    root = make_davis_tree(tmp_path_factory.mktemp("davis"))
    out = tmp_path_factory.mktemp("davis_out")
    kw = dict(init_dir=pth, davis_dir=root, S=8, stride=8, iters=1, chunk=chunk,
              resize_hw=(48, 96), max_videos=2, point_stride=16)
    want = jax_davis.main(**kw, out_dir=str(out / "jax"))
    got = run_davis.main(**kw, out_dir=str(out / "port"), device="cpu")
    assert got["trajs"].shape == want["trajs"].shape == (8, 18, 2)
    assert np.isfinite(got["mean_tps"]) and got["mean_tps"] > 0
    np.testing.assert_array_equal(got["trajs"][0], want["trajs"][0])  # the queries
    np.testing.assert_allclose(got["trajs"], want["trajs"], atol=TRAJ_PX, rtol=0)
    assert np.abs(want["trajs"] - want["trajs"][:1]).max() > 0.5  # the points moved
    assert media(out / "port") == media(out / "jax") == {"video0.gif": (8, 48, 96),
                                                        "video1.gif": (8, 48, 96)}


# --- the RAFT and DINO baselines (--modeltype raft|dino) -----------------------

BASELINE_ATE_PX = 1e-3


@pytest.fixture(scope="module")
def baseline_ckpts(tmp_path_factory):
    """Seeded weights in the release files' layouts: RAFT as
    ``raft-things.pth`` (``module.`` prefixes), DINO's ViT as
    ``dino_deitsmall8_pretrain.pth`` at dim 128 (two heads by the 64-a-head
    rule), depth 2, its pos_embed on a 4x4 grid."""
    from test_torch_raft import raft_reference_state_dict
    from test_vit_convert import make_dino_sd

    d = tmp_path_factory.mktemp("baselines")
    out = {}
    for name, sd in (("raft", raft_reference_state_dict(9)),
                     ("dino", make_dino_sd(np.random.RandomState(7), dim=128, heads=2, depth=2,
                                           patch=8, grid=4))):
        out[name] = str(d / f"{name}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, out[name])
    return out


@pytest.mark.parametrize("modeltype", ["raft", "dino"])
def test_run_flt_baselines_match_jax(baseline_ckpts, tmp_path_factory, modeltype):
    """RAFT (one iteration) and DINO on 96x128 crops: pooled ATEs within
    ``BASELINE_ATE_PX`` of JAX's, the same media."""
    root = make_flyingthings_tree(tmp_path_factory.mktemp("flt"), dset="TEST")
    logs = tmp_path_factory.mktemp("flt_logs")
    kw = dict(init_dir=baseline_ckpts[modeltype], dataset_location=root, N=8,
              crop_size=(96, 128), max_iters=2, modeltype=modeltype, raft_iters=1, log_freq=1)
    want = jax_flt.main(**kw, log_dir=str(logs / "jax"))
    got = run_flt.main(**kw, log_dir=str(logs / "port"), device="cpu")
    assert sorted(got) == sorted(want) == ["ate_all", "ate_occ", "ate_vis"]
    for k in want:
        assert np.isfinite(want[k]) == np.isfinite(got[k]), k
        if np.isfinite(want[k]):
            assert abs(got[k] - want[k]) <= BASELINE_ATE_PX, (k, got[k], want[k])
    assert np.isfinite(want["ate_all"]) and want["ate_all"] > 0
    assert media(logs / "port") == media(logs / "jax") != {}


@pytest.mark.parametrize("modeltype", ["raft", "dino"])
def test_run_crohd_baselines_match_jax(baseline_ckpts, tmp_path_factory, modeltype):
    root = make_crohd_tree(tmp_path_factory.mktemp("ht21"))
    logs = tmp_path_factory.mktemp("crohd_logs")
    kw = dict(init_dir=baseline_ckpts[modeltype], dataset_root=root, S=8, N=4, max_iters=2,
              req_occlusion=False, modeltype=modeltype, raft_iters=1, log_freq=1)
    want = jax_crohd.main(**kw, log_dir=str(logs / "jax"))
    got = run_crohd.main(**kw, log_dir=str(logs / "port"), device="cpu")
    assert sorted(got) == sorted(want) == ["ate_all", "ate_occ", "ate_vis"]
    assert np.isfinite(want["ate_all"]) and want["ate_all"] > 0
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= BASELINE_ATE_PX, (k, got[k], want[k])
    assert media(logs / "port") == media(logs / "jax") != {}


@pytest.mark.parametrize("modeltype", ["raft", "dino"])
def test_run_badja_baselines_match_jax(baseline_ckpts, tmp_path_factory, modeltype):
    """The whole 6-frame video at 64x96 through the flow chain (one RAFT
    iteration) or label propagation: PCK within one keypoint's share."""
    root = make_badja_tree(tmp_path_factory.mktemp("badja"), T=6)
    out = tmp_path_factory.mktemp("badja_out")
    kw = dict(init_dir=baseline_ckpts[modeltype], data_dir=root, max_iters=1,
              resize_hw=(64, 96), modeltype=modeltype, raft_iters=1)
    want = jax_badja.main(**kw, out_dir=str(out / "jax"))
    got = run_badja.main(**kw, out_dir=str(out / "port"), device="cpu")
    assert sorted(got) == sorted(want) == ["avg", "bear"]
    share = 100.0 / (5 * 20)  # one of the visible keypoints of frames 1..5
    assert np.isfinite(want["avg"])
    assert abs(got["avg"] - want["avg"]) <= share + 1e-9, (got, want)
    assert media(out / "port") == media(out / "jax") == {"bear_kp_vis.gif": (6, 64, 96)}
