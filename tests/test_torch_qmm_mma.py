"""The dequant matmul's bf16 arithmetic and schedules against the reference.

Row 11 (``csrc/quant_matmul.cu``) makes an int4 weight bf16 by OR-ing the
nibble into the mantissa of 128.0 and subtracting 136, then one bf16x2
multiply by T(s); int8 through f32 and one rounding. That must be the JAX
package's weight ``T(float(q) · float(T(s)))`` bit for bit. The transposed
route runs on tensor cores (mma.sync m16n8k16 bf16) with k permuted on both
operands and the rows padded to n-tiles of 8; the non-transposed route
splits k over blocks and merges their f32 partials in split order.
``torch_port_util.qmm_mma_emulate`` and ``qmm_natural_emulate`` replay
those schedules. Tolerances: against the exact sum (f64) of the same bf16
products, 1e-6 of the largest output (f32 summation order is the only
difference); against the JAX ``quant_matmul_pallas`` in interpret mode, the
limit of ``tests/test_torch_weight_only.py`` (one bf16 step of each value
plus one of the largest). A planted fault must fail ``chip_smoke.check_qmm``.
The fixture's logits step by step with the schedules in place of the kernel
must pass ``chip_smoke.check_logits`` (fixture-int on ``eval_tokens[:144]``),
and with a split dropped from the merge must fail it.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from metalchat_tpu.ops.quant_matmul_pallas import quant_matmul_pallas
from metalchat_tpu_torch.engine.generate import generate
from metalchat_tpu_torch.ops import quant_matmul as tqm
from torch_port_util import bf16_rne, magic_nibbles, qmm_mma_emulate, qmm_natural_emulate

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

IN_F, OUT_F = 384, 40  # a ragged last tile (40 = 2.5 x 16) and last step (192 = 3 x 64)


def _bf16_sweep():
    """Every bf16 of magnitude in [2**-20, 2**7), both signs, as f32."""
    bits = np.arange(0x3580, 0x4300, dtype=np.uint32)  # exponents 107 .. 133
    bits = np.concatenate([bits, bits | 0x8000])
    return torch.from_numpy((bits << 16).view(np.float32))


def test_magic_nibbles_are_unpack_int4():
    b = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    lo, hi = magic_nibbles(b)
    want = tqm.unpack_int4(b[:, None], 1).float()
    assert torch.equal(lo, want[:, 0]) and torch.equal(hi, want[:, 1])


@pytest.mark.parametrize("codes", ["int4", "int8"])
def test_bf16_product_is_one_rounding(codes):
    """q · T(s) rounded once to bf16 (the kernel's mul.rn.bf16x2, or f32 then
    cvt.rn) equals T(float(q) · float(T(s))) for every code and scale."""
    q = torch.arange(-8, 8) if codes == "int4" else torch.arange(-128, 128)
    s = _bf16_sweep()
    exact = q.double()[:, None] * s.double()[None, :]
    assert torch.equal(exact.float().double(), exact)  # the f32 product is exact
    want = (q.float()[:, None] * s[None, :]).to(torch.bfloat16).float()
    assert torch.equal(bf16_rne(exact.float()), want)


def _case(rng, rows, bits, group, transposed):
    k = IN_F // 2 if bits == 4 else IN_F
    q = rng.integers(-128, 128, (OUT_F, k) if transposed else (k, OUT_F), dtype=np.int8)
    n_groups = IN_F // group
    shape = (1, OUT_F) if n_groups == 1 else ((OUT_F, n_groups) if transposed
                                              else (n_groups, OUT_F))
    s = (rng.random(shape) * 0.01 + 0.001).astype(np.float32)
    s = torch.from_numpy(s).to(torch.bfloat16).float().numpy()  # bf16 values
    x = torch.from_numpy(rng.standard_normal((rows, IN_F)).astype(np.float32)).to(
        torch.bfloat16)
    return x, torch.from_numpy(q), torch.from_numpy(s).to(torch.bfloat16)


@pytest.mark.parametrize("transposed", [True, False], ids=["mma", "split-k"])
@pytest.mark.parametrize("group", [32, IN_F], ids=["g32", "per-channel"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 32])
def test_schedule_is_the_plain_matmul(rows, bits, group, transposed):
    rng = np.random.default_rng(100 * rows + 10 * bits + int(transposed))
    x, q, s = _case(rng, rows, bits, group, transposed)
    kw = dict(bits=bits, group_size=group)
    emulate = qmm_mma_emulate if transposed else qmm_natural_emulate
    w = tqm.dequant_weight(q, s, transposed=transposed, dtype=torch.bfloat16, **kw)
    exact = x.double() @ w.double()
    got = emulate(x, q, s, raw=True, **kw).double()
    assert float((got - exact).abs().max()) <= 1e-6 * float(exact.abs().max())
    plain = tqm.dequant_matmul_plain(x, q, s, transposed=transposed, **kw)
    out = emulate(x, q, s, **kw)
    assert out.dtype == torch.bfloat16
    # Both round f32 sums of the same products: at most one bf16 step apart.
    assert bool(((out.float() - plain.float()).abs()
                 <= 2 ** -7 * plain.float().abs() + 1e-6 * exact.abs().max()).all())


@pytest.mark.parametrize("transposed", [True, False], ids=["mma", "split-k"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 8])
def test_schedule_matches_pallas_kernel(rows, bits, transposed):
    """Against the TPU kernel in interpret mode (it takes the non-transposed
    layout: the transposed case hands it the same weight transposed)."""
    rng = np.random.default_rng(7 * rows + bits)
    x, q, s = _case(rng, rows, bits, 32, transposed)
    jq, js = (q.t(), s.t()) if transposed else (q, s)
    want = np.asarray(quant_matmul_pallas(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jnp.asarray(jq.contiguous().numpy()),
        jnp.asarray(js.float().numpy()).astype(jnp.bfloat16), bits=bits, group_size=32,
        block_out=OUT_F, block_in=IN_F, interpret=True)).astype(np.float32)
    emulate = qmm_mma_emulate if transposed else qmm_natural_emulate
    got = emulate(x, q, s, bits=bits, group_size=32).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def test_natural_plan_covers_k():
    """The wrapper's split of k: every packed row in exactly one block, a
    multiple of 8 rows a block, x's slice within the staging budget."""
    for rows in (1, 2, 8, 9, 32):
        for k, out_f in ((192, 384), (2048, 4096), (7168, 4096), (8192, 2048), (64, 100)):
            cols, n_split, per = tqm.natural_plan(rows, k, out_f, 132)
            assert per % 8 == 0 and (n_split - 1) * per < k <= n_split * per
            assert 8 * rows * per <= tqm.NAT_STAGE_BYTES or per == 8
            assert cols == (16 if rows == 1 else 8 if rows <= 8 else 4)


qmm_mod = importlib.import_module("metalchat_tpu_torch.ops.quant_matmul")
BF16_CASES = [c for c in chip_smoke.QMM_FIXTURE]
NATURAL_FAULTS = ("drop_split", "swap_lo_hi")


def _run_check(monkeypatch, fault, case, rows):
    """check_qmm with the kernel's wrapper replaced by the emulated schedule
    (one planted fault, or none)."""
    def qmm(x, q, s, *, bits, group_size, transposed):
        if transposed:
            return qmm_mma_emulate(x, q, s, bits=bits, group_size=group_size,
                                   fault=None if fault in NATURAL_FAULTS else fault)
        return qmm_natural_emulate(x, q, s, bits=bits, group_size=group_size,
                                   fault=fault if fault in NATURAL_FAULTS else None)

    monkeypatch.setattr(qmm_mod, "dequant_matmul", qmm)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_qmm(sm, [case], rows, torch.Generator().manual_seed(1),
                         torch.device("cpu"))
    return sm


@pytest.mark.parametrize("rows", [1, 3, 9])
@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_qmm_check_passes_the_schedules(monkeypatch, case, rows):
    assert _run_check(monkeypatch, None, case, rows).share["quant_matmul"] <= 1.0


# drop_split: the non-transposed cases split over k: int8 and an int4 w2 of
# 512 packed rows (at 3 and 9 rows); swap_lo_hi: the int4 non-transposed
# cases; swap_pair and drop_step: the transposed ones.
W2_INT4 = ("w2", 384, 1024, 4, 32, False)


@pytest.mark.parametrize("fault,case,rows", [
    *(("drop_split", c, 3) for c in BF16_CASES if not c[5] and c[3] == 8),
    ("drop_split", W2_INT4, 3), ("drop_split", W2_INT4, 9),
    *(("swap_lo_hi", c, 3) for c in [*BF16_CASES, W2_INT4] if not c[5] and c[3] == 4),
    *(("swap_pair", c, 3) for c in BF16_CASES if c[5]),
    *(("drop_step", c, 3) for c in BF16_CASES if c[5])], ids=str)
def test_qmm_check_fails_a_planted_fault(monkeypatch, fault, case, rows):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_check(monkeypatch, fault, case, rows)


qq_mod = importlib.import_module("metalchat_tpu_torch.quant.quantize")


@pytest.mark.parametrize("mode,fault", [("w8 g32", None), ("w4 g32", None),
                                        ("w8 g32", "drop_split")])
def test_fixture_int_logit_check(monkeypatch, mode, fault):
    quant, _ = chip_smoke.FIXTURE_INT_MODES[mode]
    params, cfg, fixture = chip_smoke.fixture_params(torch, "cpu", torch.bfloat16, quant)
    tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
    prompts = torch.from_numpy(tokens[chip_smoke.FIXTURE_INT_LOGIT_PROMPTS].reshape(3, 48))
    forced = generate(params, cfg, prompts, max_new_tokens=chip_smoke.FIXTURE_INT_LOGIT_STEPS,
                      quantized_kv=True)
    want = chip_smoke.teacher_forced_logits(params, cfg, prompts, forced)

    # Decode's 3 rows reach row 11; the prompt's 144 take the dequantized weight.
    def qmm(x, q, s, *, bits, group_size, transposed):
        if transposed:
            return qmm_mma_emulate(x, q, s, bits=bits, group_size=group_size)
        return qmm_natural_emulate(x, q, s, bits=bits, group_size=group_size, fault=fault)

    monkeypatch.setattr(qq_mod, "dequant_matmul", qmm)
    got = chip_smoke.teacher_forced_logits(params, cfg, prompts, forced)
    sm = chip_smoke.Smoke(torch)
    if fault is None:
        assert chip_smoke.check_logits(sm, mode, got, want) <= 1.0
    else:
        with pytest.raises(AssertionError, match="beyond the limit"):
            chip_smoke.check_logits(sm, mode, got, want)
