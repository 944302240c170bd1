"""The port's demos (``pips_tpu_torch.demo``, ``pips_tpu_torch.chain_demo``)
against ``examples/demo.py`` and ``examples/chain_demo.py``.

Both packages read one directory of seeded noise jpgs and one JAX msgpack
checkpoint of a TINY model (``make_pips`` patched to TINY dims in both: the
demos import it inside ``main``), at one refinement iteration, the chaos
policy of docs/TESTING.md (untrained weights amplify rounding through
floor() at every further iteration, and the visibility-driven window starts
of a chain then part). The trajectories, read where each demo draws them,
agree within 1e-3 px (measured 2.2e-4 for the windows, 3.6e-4 for the
chain), and each writes the same GIFs. The port's ``--on_device`` and
``--stream`` modes are held to its default mode.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pips_tpu.evals.common as jax_common
from pips_tpu.models import Pips as JaxPips
from pips_tpu.utils import saverloader as jax_saverloader
from pips_tpu_torch import chain_demo, demo
from pips_tpu_torch.evals import common
from pips_tpu_torch.models.pips import Pips

REPO = Path(__file__).resolve().parents[1]
DIMS = dict(latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32, mixer_depth=2)
FRAMES, FRAME_HW, HW = 16, (120, 160), (64, 96)
PX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jpg directory, JAX checkpoint directory), with ``make_pips`` of both
    packages at TINY dims for the module's tests."""
    root = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(0)
    (root / "imgs").mkdir()
    for i in range(FRAMES):
        Image.fromarray((rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)).save(
            root / "imgs" / f"{i:05d}.jpg")
    params = JaxPips(S=8, stride=4, **DIMS).init(jax.random.PRNGKey(0), jnp.ones((1, 4, 2)),
                                                 jnp.zeros((1, 8, *HW, 3)), iters=1)
    jax_saverloader.save(str(root / "ckpt"), params, 5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "make_pips",
                   lambda S=8, stride=8, dtype="float32": JaxPips(S=S, stride=stride, **DIMS))
        mp.setattr(common, "make_pips", lambda S=8, stride=8, dtype="float32", device="cuda":
                   Pips(S=S, stride=stride, **DIMS).to(device).eval())
        yield str(root / "imgs"), str(root / "ckpt")


def _example(name: str):
    """``examples/<name>.py`` as a module whose ``draw_trajs_on_rgbs`` records
    the trajectories it draws in ``module.drawn``."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.drawn = []
    draw = mod.draw_trajs_on_rgbs

    def spy(rgbs, trajs, *args, **kw):
        mod.drawn.append(np.asarray(trajs))
        return draw(rgbs, trajs, *args, **kw)

    mod.draw_trajs_on_rgbs = spy
    return mod


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, images: str, ckpt: str, out: str, points: tuple):
    mod = _example(name)
    mod.main(init_dir=ckpt, images_dir=images, out_dir=out, resize_hw=HW, iters=1,
             **dict(points))
    return mod.drawn


def _gifs(out: str) -> dict:
    """GIF name -> (frames, H, W)."""
    got = {}
    for p in sorted(Path(out).glob("*.gif")):
        with Image.open(p) as im:
            got[p.name] = (im.n_frames, im.height, im.width)
    return got


def test_demo_matches_jax(setup, tmp_path):
    images, ckpt = setup
    want = _jax_run("demo", images, ckpt, str(tmp_path / "jax"), (("grid", 4),))
    got = demo.main(init_dir=ckpt, images_dir=images, out_dir=str(tmp_path / "port"),
                    resize_hw=HW, iters=1, grid=4, device="cpu")
    assert len(got["trajs"]) == len(want) == FRAMES // 8
    for a, b in zip(got["trajs"], want):
        assert a.shape == b.shape == (8, 16, 2)
        assert np.abs(a - b).max() <= PX, np.abs(a - b).max()
    assert _gifs(str(tmp_path / "port")) == _gifs(str(tmp_path / "jax")) == {
        f"demo_chunk00{i}.gif": (8, *HW) for i in range(2)}
    assert got["gifs"] == [str(tmp_path / "port" / f"demo_chunk00{i}.gif") for i in range(2)]


CHAIN_POINTS = {"grid": (("grid", 4),), "x0 y0": (("x0", 40.0), ("y0", 30.0), ("N", 3))}


@pytest.mark.parametrize("points", sorted(CHAIN_POINTS))
def test_chain_demo_matches_jax(setup, tmp_path, points):
    images, ckpt = setup
    kw = dict(CHAIN_POINTS[points])
    (want,) = _jax_run("chain_demo", images, ckpt, str(tmp_path / "jax"), CHAIN_POINTS[points])
    got = chain_demo.main(init_dir=ckpt, images_dir=images, out_dir=str(tmp_path / "port"),
                          resize_hw=HW, iters=1, device="cpu", **kw)
    n = 16 if points == "grid" else 3
    assert got["trajs"].shape == want.shape == (FRAMES, n, 2)
    assert got["vis"].shape == (FRAMES, n) and np.isfinite(got["vis"]).all()
    np.testing.assert_array_equal(got["trajs"][0], want[0])  # the queries
    assert np.abs(got["trajs"] - want).max() <= PX, np.abs(got["trajs"] - want).max()
    assert _gifs(str(tmp_path / "port")) == _gifs(str(tmp_path / "jax")) == {
        "chain_out.gif": (FRAMES, *HW)}


@functools.lru_cache(maxsize=None)
def _port_chain(images: str, ckpt: str, out: str, mode: str) -> dict:
    return chain_demo.main(init_dir=ckpt, images_dir=images, out_dir=out, resize_hw=HW, iters=1,
                           grid=4, device="cpu", **({mode: True} if mode else {}))


@pytest.mark.parametrize("mode", ["on_device", "stream"])
def test_chain_demo_modes_equal_the_default(setup, tmp_path_factory, mode):
    images, ckpt = setup
    base = _port_chain(images, ckpt, str(tmp_path_factory.mktemp("default")), "")
    out = str(tmp_path_factory.mktemp(mode))
    got = _port_chain(images, ckpt, out, mode)
    assert np.abs(got["trajs"] - base["trajs"]).max() <= PX
    assert np.abs(got["vis"] - base["vis"]).max() <= PX
    assert _gifs(out) == {"chain_out.gif": (FRAMES, *HW)}
