"""The int8 tensor-core matvec's integer schedule against the reference.

At every row count, one included, the port's W4A8/W8A8 matvec
(``csrc/a8_matvec.cu``: ``a8_quantize`` then ``a8_mma_kernel``) permutes k
inside each 64-byte step on both operands, pads the code rows to n-tiles of
8 with zeros, splits
k over the warps of a block and sums their int32 partials, then applies the
int4 nibble identities. ``torch_port_util.a8_mma_emulate`` replays that
register by register through PTX's mma.m16n8k32 fragment layout. Its int32
result must equal the plain ``int_acc`` and the JAX package's
``quant_matvec_stacked`` (Pallas, interpret mode) exactly: integer sums do
not depend on their order. The shapes leave a ragged last step (k not a
multiple of 64) and a ragged last tile (out not a multiple of 16).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.ops.a8_matvec_pallas import quant_matvec_stacked as j_raw
from metalchat_tpu_torch.ops import a8_matvec as tm
from torch_port_util import a8_mma_emulate

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

IN_F, OUT_F, L = 320, 40, 2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 9, 16])
def test_mma_schedule_is_exact(rows, bits):
    rng = np.random.default_rng(10 * rows + bits)
    k = IN_F // 2 if bits == 4 else IN_F
    p = rng.integers(-128, 128, (L, OUT_F, k), dtype=np.int8)
    xq = rng.integers(-127, 128, (rows, IN_F), dtype=np.int8)
    xq[0, :8] = 127  # the extreme codes against the extreme bytes
    xq[-1, :8] = -127
    p[1, 0, :8] = -128
    want = np.asarray(j_raw(jnp.asarray(xq), jnp.asarray(p), 1, bits=bits, block_out=OUT_F,
                            interpret=True))

    txq, tp = torch.from_numpy(xq), torch.from_numpy(p[1])
    np.testing.assert_array_equal(tm.int_acc(txq, tp, bits).numpy(), want)
    np.testing.assert_array_equal(a8_mma_emulate(txq, tp, bits).numpy(), want)
    # The fused route: corr from a8_quantize's prologue instead of an mma.
    corr =8 * txq[:, :IN_F // 2].sum(dim=1, dtype=torch.int32) if bits == 4 else None
    np.testing.assert_array_equal(a8_mma_emulate(txq, tp, bits, corr=corr).numpy(), want)


@pytest.mark.parametrize("norm", [False, True])
def test_quantize_rows_is_the_prologue(norm):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, IN_F)).astype(np.float32))
    x[2] = 0.0  # sx = 1
    nw = torch.from_numpy(rng.random(IN_F).astype(np.float32)) if norm else None
    xq, sx, corr = tm.quantize_rows(x, nw, 1e-5 if norm else None)
    want_q, want_s = tm.prologue(x, nw, 1e-5 if norm else None)
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s.reshape(-1))
    assert torch.equal(corr, 8 * want_q[:, :IN_F // 2].sum(dim=1, dtype=torch.int32))
    assert tm.quantize_rows(x, nw, 1e-5 if norm else None, corr=False)[2] is None
