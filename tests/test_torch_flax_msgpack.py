"""The port's reader of the JAX package's msgpack checkpoints
(``pips_tpu_torch.utils.flax_msgpack``), and what reads through it: the eval
loader ``evals.common.load_params`` and the train loop's warm start
(``train.loop.warm_start_from_jax``), each against the JAX package on files
that ``pips_tpu.utils.saverloader.save`` writes.

The reader is held to ``flax.serialization.msgpack_restore`` leaf for leaf
and bit for bit; a forward through the loaded weights to JAX's through its
own ``load_params`` at one refinement iteration (the chaos policy of
docs/TESTING.md), within 1e-4 px on JAX's time steps; the warm start to JAX's restored train
state exactly.
"""

import functools

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.evals import common as jax_common
from pips_tpu.models import Pips as JaxPips
from pips_tpu.train.optim import make_optimizer as jax_make_optimizer
from pips_tpu.train.optim import onecycle_linear
from pips_tpu.train.step import TrainState
from pips_tpu.utils import saverloader as jax_saverloader
from pips_tpu_torch.convert import state_dict_from_flax
from pips_tpu_torch.evals import common
from pips_tpu_torch.models.pips import Pips
from pips_tpu_torch.train import TrainConfig
from pips_tpu_torch.train.loop import init_state, restore
from pips_tpu_torch.utils import flax_msgpack

TINY = dict(S=4, stride=8, latent_dim=16, corr_levels=3, corr_radius=2, mixer_dim=32,
            mixer_depth=2)
HW = (64, 96)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    model = JaxPips(**TINY)
    return model.init(jax.random.PRNGKey(3), jnp.ones((1, 4, 2)),
                      jnp.zeros((1, TINY["S"], *HW, 3)), iters=1)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """A train state with the JAX loop's optax chain, its moments and counts
    filled with seeded values (as after some steps)."""
    tx = jax_make_optimizer(1e-3, 100)
    state = TrainState.create(apply_fn=JaxPips(**TINY).apply, params=_jax_variables(), tx=tx)
    rng = np.random.RandomState(5)

    def fill(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("count"):
            return jnp.asarray(7, x.dtype)
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) ** 2
                           if ".nu" in key else rng.standard_normal(x.shape), x.dtype)

    return state.replace(step=7, opt_state=jax.tree_util.tree_map_with_path(fill,
                                                                            state.opt_state))


def _trees(kind: str):
    if kind == "train state":
        return _jax_state()
    if kind == "variables":
        return _jax_variables()
    if kind == "bfloat16 leaf":
        return {"w": jnp.arange(37, dtype=jnp.bfloat16) * 0.37, "f": np.ones((2, 3), np.float16)}
    if kind == "numpy scalar":
        return {"s": np.float32(2.5), "i": np.int64(-9), "b": np.bool_(True),
                "a": np.zeros((0, 3), np.int32)}
    if kind == "plain types":
        return {"c": 1.5 - 2j, "plain": [1, -3, 300, -70000, 2 ** 40, 0.25, None, True, "tëxt",
                                         b"\x00\xff", {"nested": [np.float64(1.0)]}]}
    return {"big": np.arange(3000, dtype=np.float32).reshape(30, 100), "small": np.ones(3)}


def _assert_same_tree(want, got, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        a = np.asarray(want)
        assert isinstance(got, torch.Tensor), (path, type(got))
        assert tuple(got.shape) == a.shape and str(got.dtype) == f"torch.{a.dtype.name}", path
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == a.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("kind", ["train state", "variables", "bfloat16 leaf", "chunked leaf",
                                  "numpy scalar", "plain types"])
def test_reader_equals_flax_msgpack_restore(tmp_path, monkeypatch, kind):
    """Files that ``saverloader.save`` writes; ``saverloader.save`` turns every
    leaf into an ndarray first, so numpy scalars (extension type 3), complex
    numbers (2) and msgpack's own types are written as flax's ``to_bytes``
    writes them."""
    if kind == "chunked leaf":  # flax splits arrays above MAX_CHUNK_SIZE bytes
        monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 1024)
    if kind in ("numpy scalar", "plain types"):
        path = tmp_path / "model-000000012.msgpack"
        path.write_bytes(flax_serialization.to_bytes(_trees(kind)))
    else:
        path = jax_saverloader.save(str(tmp_path), _trees(kind), 12)
    monkeypatch.undo()
    data = open(path, "rb").read()
    if kind == "chunked leaf":
        assert b"__msgpack_chunked_array__" in data
    want = flax_serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    _assert_same_tree(want, got)
    raw, step = flax_msgpack.load_raw(str(tmp_path))
    assert step == 12 and flax_msgpack.list_steps(str(tmp_path)) == [12]
    _assert_same_tree(want, raw)


@pytest.mark.parametrize("data,match", [
    (b"", "truncated"), (b"\x92\x01", "truncated"), (b"\x01\x02", "after the document"),
    (b"\xc1", "starts no msgpack value"), (b"\xd4\x05\x00", "extension type 5"),
    (b"\xd4\x01\x00", "not \\(shape, dtype, bytes\\)")])
def test_reader_refuses_what_flax_does_not_write(data, match):
    with pytest.raises(flax_msgpack.DecodeError, match=match):
        flax_msgpack.restore(data)


@pytest.mark.parametrize("times,tol", [("jax", 1e-4), ("own", 1e-3)])
@pytest.mark.parametrize("kind", ["train state", "variables"])
def test_load_params_forward_equals_jax_load_params(tmp_path, monkeypatch, kind, times, tol):
    """The time embedding reads ``linspace(0, S, S)`` at frequencies up to
    969, where ``jnp.linspace`` and ``torch.linspace`` differ by an ulp
    (ROADMAP §C, "Not faults"): fed JAX's time steps the port agrees within
    1e-4 px, with its own within 1e-3."""
    if times == "jax":
        monkeypatch.setattr(torch, "linspace", lambda a, b, n, **kw: torch.from_numpy(
            np.array(jnp.linspace(a, b, n))).to(kw.get("device")))
    jax_saverloader.save(str(tmp_path), _trees(kind), 4)
    params = jax_common.load_params(JaxPips(**TINY), str(tmp_path), example_hw=HW)
    model = common.load_params(Pips(**TINY).eval(), str(tmp_path))
    rng = np.random.RandomState(1)
    rgbs = (rng.rand(1, TINY["S"], *HW, 3) * 255).astype(np.float32)
    xys = (rng.rand(1, 6, 2) * [HW[1] - 8, HW[0] - 8] + 4).astype(np.float32)
    want = JaxPips(**TINY).apply(params, jnp.asarray(xys), jnp.asarray(rgbs), iters=1,
                                 is_train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(xys), torch.from_numpy(rgbs), iters=1, is_train=False)
    d = np.abs(got.coord_predictions[-1].numpy() - np.asarray(want.coord_predictions[-1]))
    assert d.max() <= tol, d.max()
    np.testing.assert_allclose(got.vis_e.numpy(), np.asarray(want.vis_e), atol=tol)


def _cfg(tmp_path, **kw) -> TrainConfig:
    return TrainConfig(**{k: v for k, v in TINY.items() if k != "S"}, S=TINY["S"],
                       dataset="synthetic", max_iters=100, crop_size=HW, init_dir=str(tmp_path),
                       ckpt_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"), **kw)


@pytest.mark.parametrize("ignore", [None, "fnet"])
def test_warm_start_restores_jax_train_state(tmp_path, ignore):
    """Step, parameters, Adam moments and counts, and the schedule's rate, as
    JAX's ``saverloader.load`` restores its train state (with ``ignore_load``,
    leaves whose key path holds the substring keep the fresh state's)."""
    jax_saverloader.save(str(tmp_path), _jax_state(), 7)
    cfg = _cfg(tmp_path, load_optimizer=True, load_step=True, ignore_load=ignore)
    target = _jax_state().replace(
        step=0, opt_state=jax.tree.map(jnp.zeros_like, _jax_state().opt_state))
    target = target.replace(params=jax.tree.map(jnp.zeros_like, target.params))
    want, want_step = jax_saverloader.load(str(tmp_path), target, ignore_load=ignore)

    model, opt = init_state(cfg, "cpu")
    for p in model.parameters():  # the fresh values, as JAX's target above
        p.data.zero_()
    assert restore(cfg, model, opt, str(tmp_path / "c" / "run")) == want_step == 7

    sd = state_dict_from_flax(jax.tree.map(np.asarray, want.params))
    adam, schedule = want.opt_state[1][0], want.opt_state[1][2]
    mu = state_dict_from_flax(jax.tree.map(np.asarray, adam.mu))
    nu = state_dict_from_flax(jax.tree.map(np.asarray, adam.nu))
    ignored = 0
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), sd[name], err_msg=name)
        st = opt.adamw.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name], err_msg=name)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[name], err_msg=name)
        assert float(st["step"]) == int(adam.count) == 7
        ignored += name.startswith("fnet.") and not np.any(mu[name])
    assert ignored == (sum(n.startswith("fnet.") for n, _ in model.named_parameters())
                       if ignore else 0)
    assert int(schedule.count) == 7 and opt.scheduler.last_epoch == 7
    assert opt.lr == pytest.approx(float(onecycle_linear(cfg.lr, cfg.max_iters + 100)(7)),
                                   rel=1e-7)


@pytest.mark.parametrize("kind", ["variables", "train state"])
def test_warm_start_without_optimizer_takes_the_parameters(tmp_path, kind):
    """Without ``load_optimizer`` only the parameters load (JAX's loop reads
    them from a bare variables tree; the port also from a train state's
    ``params``); the step stays 0 without ``load_step``, the optimizer fresh."""
    jax_saverloader.save(str(tmp_path), _trees(kind), 3)
    cfg = _cfg(tmp_path, ignore_load="delta_block")
    model, opt = init_state(cfg, "cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    assert restore(cfg, model, opt, str(tmp_path / "c" / "run")) == 0
    want = state_dict_from_flax(jax.tree.map(np.asarray, _jax_variables()))
    for name, v in model.state_dict().items():
        exp = fresh[name].numpy() if name.startswith("delta_block.") else want[name]
        np.testing.assert_array_equal(v.numpy(), exp, err_msg=name)
    assert not opt.adamw.state


def test_warm_start_refuses_optimizer_from_bare_variables(tmp_path):
    jax_saverloader.save(str(tmp_path), _jax_variables(), 3)
    cfg = _cfg(tmp_path, load_optimizer=True)
    model, opt = init_state(cfg, "cpu")
    with pytest.raises(ValueError, match="holds no train state"):
        restore(cfg, model, opt, str(tmp_path / "c" / "run"))
