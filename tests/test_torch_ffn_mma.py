"""The merged FFN block's schedule (``csrc/ffn_block.cu``) against the
reference, f32 on the CPU.

The kernel computes each phase's int8 codes once a row (a8_matvec's
prologue), streams each block's tiles of wo, w13 and w2 through one ring in
the order its feed issues them, and dots them on the route's integer
schedule: exact dp4a sums at one row, the int8 tensor-core tile of
``a8_mma_kernel`` at 2-16 rows (``torch_port_util.a8_mma_emulate``, with the
prologue's int4 correction). ``torch_port_util.ffn_block_emulate`` replays
that, with the kernel's f32 glue. Its integer sums are exact, so it must
equal the plain ``ffn_block_plain`` bit for bit; against the JAX package's
``ffn_block_stacked`` (Pallas, interpret mode) it is held as
tests/test_torch_ffn_block.py holds the plain version: 1e-5 relative (plus
1e-6 of the largest output), and rows whose norm or h codes sit within 1e-4
of a rounding half to four quanta of h's effect on the output,
``4·sx_h·s_w2·qmax`` (an ulp of the f32 mean or the activation between
torch and XLA can move such a code by one).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.ops.ffn_block_pallas import ffn_block_stacked as j_ffn
from metalchat_tpu_torch.ops import a8_matvec as am
from metalchat_tpu_torch.ops import ffn_block as fb
from torch_port_util import (ffn_block_emulate, ffn_weights_np, near_rounding_boundary,
                             ring_stages)

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 9, 16])
def test_ffn_schedule_matches_plain_and_pallas(rows, bits, act):
    H, F = (256, 512) if bits == 4 else (128, 256)
    L, eps, layer, offset = 2, 1e-5, 1, 1.0 if act == "gelu_tanh" else 0.0
    rng = np.random.default_rng(100 * rows + 10 * bits + (act == "silu"))
    w = ffn_weights_np(rng, L, H, F, bits)
    attn = rng.standard_normal((rows, H)).astype(np.float32)
    x = rng.standard_normal((rows, H)).astype(np.float32)
    jw = dict(w, norm_w=w["norm_w"][:, None, :])
    want = np.asarray(j_ffn(jnp.asarray(attn), jnp.asarray(x), *map(jnp.asarray, (
        jw["wo_q"], jw["wo_s"], jw["norm_w"], jw["w13_q"], jw["w13_s"], jw["w2_q"],
        jw["w2_s"])), layer, bits=bits, act=act, eps=eps, offset=offset, interpret=True))

    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    ta, tx = torch.from_numpy(attn), torch.from_numpy(x)
    scratch = {}
    got = ffn_block_emulate(ta, tx, *tw.values(), layer, bits=bits, act=act, eps=eps,
                            offset=offset, scratch=scratch)
    assert torch.equal(got, fb.ffn_block_plain(ta, tx, *tw.values(), layer, bits=bits,
                                               act=act, eps=eps, offset=offset))
    xf = scratch["x2"]
    normed = xf * torch.rsqrt(xf.square().mean(1, keepdim=True) + eps) * (
        offset + tw["norm_w"][layer])
    _, sx_n = am.prologue(xf, tw["norm_w"][layer], eps, offset)
    _, sx_h = am.act_quantize(scratch["h"])
    tie = near_rounding_boundary(normed, sx_n) | near_rounding_boundary(scratch["h"], sx_h)
    got = got.numpy()
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-5, atol=1e-6 * np.abs(want).max())
    quanta = 4 * sx_h.numpy() * w["w2_s"][layer].reshape(1, -1) * (8 if bits == 4 else 127)
    assert np.all(np.abs(got[tie] - want[tie]) <= quanta[tie] + 1e-5 * np.abs(want[tie]))


@pytest.mark.parametrize("grid", [1, 2, 7, 40])
@pytest.mark.parametrize("tile_rows,chunk", [(8, 2048), (16, 1024)])
@pytest.mark.parametrize("rows,k,subs,stride", [(4128, 2064, 1, 0), (3000, 2064, 2, 3000),
                                                (4128, 7168, 1, 0), (40, 48, 1, 0)])
def test_ring_walks_cover_every_weight_byte_once(grid, tile_rows, chunk, rows, k, subs, stride):
    """The blocks' walks (``ring_stages``, the kernel's WeightStream) cover
    each byte of wo, w13 and w2 once, whatever the grid, in both of the
    ring's geometries (one row; 2-16 rows): widths that leave a ragged last
    chunk and a ragged last tile, w13 as gate and up sub-tiles."""
    hits = np.zeros((subs * rows, k), np.int64)
    for blk in range(grid):
        for r0, live, c0, n in ring_stages(blk, grid, rows, k, subs, stride, tile_rows, chunk):
            assert 0 < live <= tile_rows and 0 < n <= chunk and n % 16 == 0
            hits[r0:r0 + live, c0:c0 + n] += 1
    assert (hits == 1).all()
