"""The port's BasicEncoder against the JAX BasicEncoder, same weights.

f32 (JAX ``full_s2d=False``): tight, 1e-4 on outputs of magnitude ~5 (the
two differ in summation order only). bf16 (JAX default ``full_s2d=True``,
whose W-space-to-depth convs equal the port's plain convs in exact math):
~20 bf16 conv/norm layers round at other places in the two frameworks, so the
bound is a few bf16 ulps at the output's magnitude (0.25 max, 0.03 mean).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pips_tpu.models import BasicEncoder as JaxEncoder
from pips_tpu_torch.convert import load_flax_params
from pips_tpu_torch.models.encoder import BasicEncoder, instance_norm

CASES = {
    "float32": dict(stage_dims=(16, 24, 32, 32), jdtype=None, full_s2d=False),
    "bfloat16": dict(stage_dims=(64, 32, 32, 32), jdtype=jnp.bfloat16, full_s2d=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    c = CASES[dtype]
    frames = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32) * 2 - 1
    jm = JaxEncoder(output_dim=16, stride=8, stage_dims=c["stage_dims"], dtype=c["jdtype"],
                    full_s2d=c["full_s2d"])
    x = jnp.asarray(frames)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    want = np.asarray(jax.jit(jm.apply)(params, x), np.float32)

    tm = BasicEncoder(16, 8, c["stage_dims"], dtype=getattr(torch, dtype) if c["jdtype"] else None)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 8, 12, 16)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want)
        assert err.max() < 0.25 and err.mean() < 0.03, (err.max(), err.mean())


def test_instance_norm_matches_jax():
    from pips_tpu.models.encoder import instance_norm as jax_instance_norm

    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32) * 3 + 1
    got = instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_instance_norm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
