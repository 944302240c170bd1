"""The port's dataset generation (``pips_tpu_torch/datagen``) and its CLI
helper (``utils/cli.py``) against the JAX package's, on the synthetic flow
scenes of ``tests/test_datagen.py`` and the raw FlyingThings tree of
``tests/test_datagen_e2e.py``: the same trajectories, the same accepted
occluders and the same files, which the port's FlyingThings++ reader then
loads as the JAX package's does. All exact.
"""

import os

import numpy as np
import pytest

from test_datagen import make_translating_scene
from test_datagen_e2e import raw_tree  # noqa: F401  (the module-scoped fixture)

from pips_tpu.datagen import occluders as jax_occluders
from pips_tpu.datagen import run as jax_run
from pips_tpu.datagen import trajs as jax_trajs
from pips_tpu.utils import cli as jax_cli
from pips_tpu_torch.datagen import chain_flow_trajs, consider_id, filter_trajs, flood_fill_hull
from pips_tpu_torch.datagen import occluders, run, trajs
from pips_tpu_torch.utils import cli


@pytest.mark.parametrize("vel", [(2.0, 1.0), (-1.5, 0.5)])
def test_chain_and_filter_equal_jax(vel):
    masks, ff, fb = make_translating_scene(vel=vel)
    got = chain_flow_trajs(ff)
    np.testing.assert_array_equal(got, jax_trajs.chain_flow_trajs(ff))
    H, W = masks.shape[1:]
    px = 20 * W + 20  # inside the box: moves with it
    np.testing.assert_allclose(got[1, px] - got[0, px], vel, atol=1e-5)
    kept = filter_trajs(got, masks, ff, fb)
    assert kept.shape[1] > 0
    np.testing.assert_array_equal(kept, jax_trajs.filter_trajs(got, masks, ff, fb))
    clip = trajs.make_trajs_for_clip(ff, fb, masks, min_trajs=16)
    np.testing.assert_array_equal(clip, jax_trajs.make_trajs_for_clip(ff, fb, masks,
                                                                       min_trajs=16))
    assert trajs.make_trajs_for_clip(ff, fb, masks, min_trajs=10 ** 6) is None


def test_occluders_equal_jax():
    masks, ff, fb = make_translating_scene(H=96, W=128, box=(10, 10, 60, 60))
    got = consider_id(1.0, masks, ff, fb)
    assert got is not None and got.shape[1] > 0 and got.dtype == np.float16
    np.testing.assert_array_equal(got, jax_occluders.consider_id(1.0, masks, ff, fb))
    assert consider_id(0.0, masks, ff, fb) is None
    d, e = occluders.extract_occluders_for_clip(masks, ff, fb), \
        jax_occluders.extract_occluders_for_clip(masks, ff, fb)
    assert sorted(d) == sorted(e) == ["1"]
    np.testing.assert_array_equal(d["1"], e["1"])
    fill, hull = flood_fill_hull(masks[0].astype(np.int64))
    want, _ = jax_occluders.flood_fill_hull(masks[0].astype(np.int64))
    np.testing.assert_array_equal(fill, want)


def test_datagen_run_writes_the_jax_files_and_the_reader_loads_them(
        raw_tree, tmp_path):  # noqa: F811
    """``datagen.run.main`` of both packages on copies of one raw tree: the
    same ``trajs_at_0.npz`` and ``occluder_at_0.npy``; the port's
    FlyingThings++ reader then gives the JAX reader's sample on them."""
    import shutil

    from pips_tpu.data.flyingthings import FlyingThingsDataset as JaxDataset
    from pips_tpu_torch.data.flyingthings import FlyingThingsDataset

    roots = []
    for name, main in (("port", run.main), ("jax", jax_run.main)):
        root = str(tmp_path / name)
        shutil.copytree(raw_tree, root)
        for what in ("trajs", "occluders"):
            main(what=what, flt3d_path=root, dsets=("TRAIN",), subsets=("A",), starts=(0,))
        roots.append(root)
    traj_f = "trajs_ad/TRAIN/A/0000000/left/trajs_at_0.npz"
    occ_f = "occluders_al/TRAIN/A/0000000/left/occluder_at_0.npy"
    a, b = (dict(np.load(os.path.join(r, traj_f)))["trajs"] for r in roots)
    assert a.shape[0] == 8 and a.shape[1] >= 256
    np.testing.assert_array_equal(a, b)
    a, b = (np.load(os.path.join(r, occ_f), allow_pickle=True).item() for r in roots)
    assert sorted(a) == sorted(b) and "1" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])

    kw = dict(dset="TRAIN", subset="A", N=16, S=8, crop_size=(64, 96), use_augs=False)
    port, jax = FlyingThingsDataset(roots[0], **kw), JaxDataset(roots[0], **kw)
    assert len(port) == 1
    (sa, ga), (sb, gb) = port[0], jax[0]
    assert ga and gb
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _fn(a: int = 1, b: float = 2.0, c: bool = False, d=(1, 2), e: str = "x"):
    return dict(a=a, b=b, c=c, d=d, e=e)


@pytest.mark.parametrize("argv", [[], ["--a", "3", "--b=0.5", "--c"],
                                  ["--d", "(4,5,6)", "--e", "y"], ["--c", "no", "--a=-2"]])
def test_auto_cli_equals_jax(argv):
    assert cli.auto_cli(_fn, argv) == jax_cli.auto_cli(_fn, argv)
    with pytest.raises(SystemExit):
        cli.auto_cli(_fn, ["--nope", "1"])
    with pytest.raises(SystemExit):
        cli.auto_cli(_fn, ["positional"])
