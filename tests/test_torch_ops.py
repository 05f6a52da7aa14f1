"""Port reference ops (metalchat_tpu_torch/ops/reference.py) vs the JAX
package's ops/xla.py, f32 on the CPU.

Tolerance rtol = atol = 1e-5: the same op order in both, but libm
(cos/sin/exp) and rsqrt implementations differ by a few ulps.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.config import RopeScaling as JRopeScaling
from metalchat_tpu.ops import xla as xops
from metalchat_tpu_torch.config import RopeScaling
from metalchat_tpu_torch.ops import reference as ops

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    want = [np.asarray(xops.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5, offset=mu))
            for mu in (0.0, 1.0)]

    for mu, ref in zip((0.0, 1.0), want):
        got = ops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5, offset=mu)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_tables_and_rotation(scaled):
    rng = np.random.default_rng(1)
    hd, t = 64, 96
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, t, (2, 7)).astype(np.int32)
    scaling = JRopeScaling(factor=8.0, original_max_position_embeddings=64) if scaled else None
    cos, sin = xops.precompute_rope(hd, t, 10000.0, scaling)
    rot = xops.apply_rope(jnp.asarray(x), cos, sin, jnp.asarray(pos))
    rows = xops.apply_rope_rows(jnp.asarray(x), cos[pos], sin[pos])
    want = [np.asarray(a) for a in (cos, sin, rot, rows)]

    tscaling = RopeScaling(factor=8.0, original_max_position_embeddings=64) if scaled else None
    tcos, tsin = ops.precompute_rope(hd, t, 10000.0, tscaling)
    tp = torch.from_numpy(pos).long()
    got = [tcos, tsin,
           ops.apply_rope(torch.from_numpy(x), tcos, tsin, tp),
           ops.apply_rope_rows(torch.from_numpy(x), tcos[tp], tsin[tp])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_causal_mask_and_attention(window):
    rng = np.random.default_rng(2)
    b, s, nh, nkv, t, hd = 2, 6, 4, 2, 16, 32
    q = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, nkv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, t, hd)).astype(np.float32)
    pos = (np.array([[3], [9]]) + np.arange(s)[None]).astype(np.int32)
    valid = np.array([9, 15], np.int32)[:, None, None]
    mask = xops.causal_mask(jnp.asarray(pos), t, jnp.asarray(valid), window)
    out = xops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, scale=0.17)
    want_mask, want = np.asarray(mask), np.asarray(out)

    tmask = ops.causal_mask(torch.from_numpy(pos), t, torch.from_numpy(valid), window)
    np.testing.assert_array_equal(tmask.numpy(), want_mask)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        tmask, scale=0.17)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_swiglu():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w1, w3 = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    w2 = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    want = np.asarray(xops.swiglu(*(jnp.asarray(a) for a in (x, w1, w3, w2)), "silu"))

    got = ops.swiglu(*(torch.from_numpy(a) for a in (x, w1, w3, w2)), "silu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
