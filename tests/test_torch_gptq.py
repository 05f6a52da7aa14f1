"""GPTQ in the port (metalchat_tpu_torch/quant/gptq.py) against the JAX
package's quant/gptq.py, on the CPU.

The port runs the recursion in torch f64 (numpy f64 in JAX): the rank-1
updates are a rounded product and a rounded difference on both sides, but
``inv`` and ``cholesky`` come from different LAPACK builds and may differ in
the last ulp, and a code that flips at a .5 boundary feeds a different error
into the channels after it. So codes are held at a stated share, each within
one quantum, with the per-channel Hessian objective (w − s·q)ᵀH(w − s·q)
beside them (`chip_smoke.GPTQ_TOLERANCE`, the limits the card's comparison
uses too):

* codes: at most 2% differ, each by one quantum;
* objective: the sum over channels within 1% relative.

Measured here: the codes are identical on every case below. Other
tolerances:

* `hessian_tap`: within 1e-5 of the largest entry (f32 products summed in
  another order);
* `gptq_quantize_params` on the tiny Llama, W4A8: logits within 2e-3 of the
  largest |logit| (act-quant flips, as for any W4A8 tree);
* the fixture's W4A8 GPTQ perplexity within 0.5% of JAX's (relative).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.quant import gptq as jgptq
from metalchat_tpu.quant import ppl as jppl
from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.config import LlamaConfig, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.quant import awq, gptq, perplexity
from test_model import TINY_LLAMA
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
TINY = LlamaConfig(**{f.name: getattr(TINY_LLAMA, f.name)
                      for f in dataclasses.fields(LlamaConfig)})
CODE_SHARE, OBJ_RTOL = chip_smoke.GPTQ_TOLERANCE
A8_SHARE = 2e-3
PPL_RTOL = 5e-3


def _spd(rng, n, tokens, spread=3.0):
    """XᵀX of `tokens` rows whose channels have magnitudes up to 1+spread
    (tokens < n: rank-deficient, made definite by the damping)."""
    x = rng.standard_normal((tokens, n)) * (1 + spread * rng.random(n))
    return (x.T @ x).astype(np.float32).astype(np.float64)


def _objective(w, q, s, H):
    e = w - q * s
    return np.einsum("io,io->o", e, H @ e)


def _check_codes(got, want, w, s, H, what):
    d = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(d).max() <= 1, f"{what}: a code differs by {np.abs(d).max()}"
    assert (d != 0).mean() <= CODE_SHARE, f"{what}: {(d != 0).mean():.4f} of the codes differ"
    og, ow = _objective(w, got, s, H).sum(), _objective(w, want, s, H).sum()
    assert abs(og - ow) <= OBJ_RTOL * ow, f"{what}: objective {og} against {ow}"
    return (d != 0).mean()


def test_identity_hessian_is_round_to_nearest():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)) * 0.05
    s = jgptq._channel_scales(w, 7.0, False)
    rtn = np.clip(np.round(w * (1.0 / s)), -7, 7)
    q = gptq.gptq_rounding(torch.from_numpy(w), torch.from_numpy(s),
                           torch.eye(48, dtype=torch.float64), qmax=7.0)
    np.testing.assert_array_equal(q.numpy(), rtn)


@pytest.mark.parametrize("damp", [0.01, 0.1])
@pytest.mark.parametrize("n,out,tokens,qmax,act_order", [
    (64, 48, 256, 7.0, True), (256, 96, 1024, 7.0, True), (512, 64, 300, 7.0, True),
    (256, 96, 1024, 127.0, True), (128, 40, 512, 7.0, False)])
def test_gptq_rounding_matches_jax(n, out, tokens, qmax, act_order, damp):
    rng = np.random.default_rng(n + out)
    H = _spd(rng, n, tokens)
    H[5, :] = H[:, 5] = 0.0  # a dead channel: its row of w is zeroed
    w = rng.standard_normal((n, out)) * 0.05
    s = jgptq._channel_scales(w, qmax, True)
    want = jgptq.gptq_rounding(w, s, H, qmax=qmax, act_order=act_order, damp=damp)
    got = gptq.gptq_rounding(torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(H),
                             qmax=qmax, act_order=act_order, damp=damp).numpy()
    assert got.dtype == np.int8
    _check_codes(got, want, w, s, H, f"n={n} damp={damp}")


def test_batched_rounding_equals_one_at_a_time():
    """A leading batch axis (layers, or leaves that share a tap side by
    side) gives each matrix the codes it gets alone."""
    rng = np.random.default_rng(1)
    Hs = np.stack([_spd(rng, 64, 128) for _ in range(3)])
    ws = rng.standard_normal((3, 64, 24)) * 0.05
    ss = np.stack([jgptq._channel_scales(w, 7.0, True) for w in ws])
    batched = gptq.gptq_rounding(torch.from_numpy(ws), torch.from_numpy(ss),
                                 torch.from_numpy(Hs), qmax=7.0).numpy()
    for i in range(3):
        one = gptq.gptq_rounding(torch.from_numpy(ws[i]), torch.from_numpy(ss[i]),
                                 torch.from_numpy(Hs[i]), qmax=7.0).numpy()
        np.testing.assert_array_equal(batched[i], one)


def test_failed_factorization_falls_back_and_is_counted():
    """An indefinite H (damping cannot save it): JAX's identity factor, i.e.
    round-to-nearest, and one failure in the caller's list."""
    H = np.array([[1.0, 2.0], [2.0, 1.0]])
    w = np.array([[0.3, -0.2], [0.11, 0.05]])
    s = np.array([0.1, 0.1])
    want = jgptq.gptq_rounding(w, s, H, qmax=7.0)
    failures = []
    got = gptq.gptq_rounding(torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(H),
                             qmax=7.0, failures=failures)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.clip(np.round(w * (1.0 / s)), -7, 7))
    assert len(failures) == 1 and bool(failures[0])


def test_channel_scales_and_refit_match_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 32)) * 0.05
    w[:, 3] = 0.0
    H = _spd(rng, 128, 400)
    for clip in (False, True):
        np.testing.assert_array_equal(
            gptq._channel_scales(torch.from_numpy(w), 7.0, clip).numpy(),
            jgptq._channel_scales(w, 7.0, clip))
    s = jgptq._channel_scales(w, 7.0, True)
    q = jgptq.gptq_rounding(w, s, H, qmax=7.0).astype(np.float64)
    want = jgptq._refit_scales(w, q, H, s)
    got = gptq._refit_scales(torch.from_numpy(w), torch.from_numpy(q), torch.from_numpy(H),
                             torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("act_order", [True, False])
def test_refit_never_worse_per_channel(act_order):
    rng = np.random.default_rng(3)
    H = torch.from_numpy(_spd(rng, 192, 700))
    w = torch.from_numpy(rng.standard_normal((192, 64)) * 0.05)
    kw = dict(qmax=7.0, clip_search=True, act_order=act_order, damp=0.01, failures=None)
    q0, s0 = gptq._gptq_codes(w, H, refit_iters=0, **kw)
    q2, s2 = gptq._gptq_codes(w, H, refit_iters=2, **kw)
    o0 = _objective(w.numpy(), q0.numpy().astype(np.float64), s0.numpy(), H.numpy())
    o2 = _objective(w.numpy(), q2.numpy().astype(np.float64), s2.numpy(), H.numpy())
    assert np.all(o2 <= o0 * (1 + 1e-12))
    assert (o2 < o0).mean() > 0.5  # the refit helps most channels here


@pytest.mark.parametrize("refit_iters", [0, 2])
def test_gptq_quantize_matches_jax(refit_iters):
    """One leaf through `gptq_quantize` (per-channel W4A8, packed, auto-
    oriented): the same layout, codes and scales at the stated tolerance."""
    rng = np.random.default_rng(4)
    H = _spd(rng, 128, 500)
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    want = jgptq.gptq_quantize(w, H, refit_iters=refit_iters)
    got = gptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(H),
                             refit_iters=refit_iters)
    assert (got.bits, got.group_size, got.transposed, got.act_bits) == (
        want.bits, want.group_size, want.transposed, want.act_bits)
    assert got.q.shape == want.q.shape and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-6)


def test_hessian_tap_matches_jax():
    h = np.random.default_rng(5).standard_normal((3, 40, 64)).astype(np.float32)
    want = jgptq.hessian_tap(jnp.asarray(h))
    got = gptq.hessian_tap(torch.from_numpy(h)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _codes(qt):
    q = qt.q.numpy().astype(np.int16) if torch.is_tensor(qt.q) else np.asarray(qt.q).astype(
        np.int16)
    if qt.bits == 4:
        q = np.concatenate([(q & 15) - 8, q >> 4], axis=-1)
    return q


@pytest.mark.parametrize("awq_alpha", [None, 0.3])
def test_gptq_quantize_params_matches_jax(awq_alpha):
    """The tiny Llama, W4A8 with one scale refit: every leaf's codes at the
    stated tolerance (the Hessians are the port's own, an ulp away), the
    logits of a 12-token prefill within 2e-3 of the largest."""
    jparams = jinit_random_params(TINY_LLAMA, seed=7, dtype=jnp.float32)
    tokens = np.random.default_rng(7).integers(0, TINY.vocab_size, (4, 32)).astype(np.int32)
    want = jgptq.gptq_quantize_params(jparams, TINY_LLAMA, jnp.asarray(tokens), bits=4,
                                      awq_alpha=awq_alpha, refit_iters=1)
    failures = []
    got = gptq.gptq_quantize_params(params_from_numpy(jax_tree_to_numpy(jparams), "cpu"), TINY,
                                    torch.from_numpy(tokens), bits=4, awq_alpha=awq_alpha,
                                    refit_iters=1, failures=failures)
    assert failures and not any(bool(f.any()) for f in failures)
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        g, w = got["layers"][name], want["layers"][name]
        assert (g.bits, g.group_size, g.transposed, g.act_bits, tuple(g.q.shape)) == (
            w.bits, w.group_size, w.transposed, w.act_bits, tuple(w.q.shape)), name
        d = _codes(g) - _codes(w)
        assert np.abs(d).max() <= 1 and (d != 0).mean() <= CODE_SHARE, name
    prompt = tokens[:1, :12]
    ref, _ = jforward(want, JKVCache.create(TINY_LLAMA, 1, 16, dtype=jnp.float32),
                      jnp.asarray(prompt), 0, TINY_LLAMA)
    out, _ = forward(got, KVCache.create(TINY, 1, 16, dtype=torch.float32, device="cpu"),
                     torch.from_numpy(prompt), 0, TINY)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=A8_SHARE * np.abs(ref).max())


def test_fixture_gptq_perplexity_matches_jax():
    """The trained fixture, W4A8 GPTQ (calibration 8 x 64 eval tokens), its
    perplexity on a later batch within 0.5% of JAX's."""
    jcfg = jload_config(FIXTURE / "config.json")
    cfg = load_config(FIXTURE / "config.json")
    jparams = jload_params(jopen(FIXTURE), jcfg, dtype=jnp.float32, max_seq_len=64)
    ev = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    calib = ev[:8 * 64].reshape(8, 64)
    batch = ev[4096:4096 + 4 * 64].reshape(4, 64)
    want = jppl.perplexity(jgptq.gptq_quantize_params(jparams, jcfg, jnp.asarray(calib)),
                           jcfg, jnp.asarray(batch))
    params = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    got = perplexity(gptq.gptq_quantize_params(params, cfg, torch.from_numpy(calib)), cfg,
                     batch)
    assert abs(got - want) <= PPL_RTOL * want, (got, want)


@pytest.mark.parametrize("awq_alpha", [None, 0.5])
def test_chip_gptq_comparison_helper(awq_alpha):
    """chip_smoke's gptq-1b comparison on the tiny Llama, both sides on the
    CPU: `gptq_against_cpu` on every GPTQ_COMPARE leaf (and, with the AWQ
    fold, `gptq_against_cpu_all`, which also holds the fold byte for byte)
    passes on codes made by `gptq_quantize_params`, `unpack_codes` reads
    back the codes `_gptq_codes` makes, and the comparison fails on a tree
    made without the refit."""
    jparams = jinit_random_params(TINY_LLAMA, seed=8, dtype=jnp.float32)
    params = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, TINY.vocab_size, (4, 32)))
    q = gptq.gptq_quantize_params(params, TINY, tokens, bits=4, refit_iters=2,
                                  awq_alpha=awq_alpha)
    sm = chip_smoke.Smoke(torch)
    folded = params if awq_alpha is None else awq.awq_fold(
        params, TINY, awq.calibration_stats(params, TINY, tokens), alpha=awq_alpha)
    hess = awq.calibration_stats(folded, TINY, tokens, tap=gptq.hessian_tap)
    if awq_alpha is not None:
        chip_smoke.gptq_against_cpu_all(sm, "tiny", TINY, params, tokens, q, awq_alpha)
    for name in chip_smoke.GPTQ_COMPARE:
        chip_smoke.gptq_against_cpu(sm, "tiny", name, folded["layers"][name][0],
                                    hess[gptq._TAP_OF[name]][0], q["layers"][name], 16)
    codes, _ = gptq._gptq_codes(folded["layers"]["wo"][0].double(), hess["wo"][0], qmax=7.0,
                                clip_search=True, act_order=True, damp=0.01, refit_iters=2,
                                failures=None)
    assert torch.equal(chip_smoke.unpack_codes(q["layers"]["wo"], 0), codes.to(torch.int16))
    no_refit = gptq.gptq_quantize_params(params, TINY, tokens, bits=4, awq_alpha=awq_alpha)
    with pytest.raises(AssertionError, match="w1 (codes|objective)"):
        chip_smoke.gptq_against_cpu(sm, "tiny", "w1", folded["layers"]["w1"][0],
                                    hess["w13"][0], no_refit["layers"]["w1"], 64)


def test_ppl_codes_check_tells_modes_apart():
    """chip_smoke's `codes_against_cpu` on the fixture's calibrated ppl
    trees (quantized here on the CPU): a tree passes against itself, and
    fails against each of the other GPTQ modes and against plain W4A8 with
    `clip_search` (a path that skipped the refit, the AWQ fold or GPTQ)."""
    cfg = load_config(FIXTURE / "config.json")
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors

    params = load_params(open_safetensors(FIXTURE), cfg, dtype=torch.float32, device="cpu")
    ev = np.load(FIXTURE / "eval_tokens.npy").astype(np.int64)
    calib = torch.from_numpy(ev[:8 * 64].reshape(8, 64))
    modes = ("w4a8 gptq", "w4a8 gptq refit", "w4a8 awq gptq", "w4a8 clip_search")
    trees = {m: chip_smoke.ppl_candidate(chip_smoke.PPL_MODES[m], params, cfg, calib)
             for m in modes}
    sm = chip_smoke.Smoke(torch)
    for m in modes:
        assert chip_smoke.codes_against_cpu(sm, m, trees[m], trees[m]) == (0.0, 0)
    for m in modes[1:]:
        with pytest.raises(AssertionError, match="codes differ"):
            chip_smoke.codes_against_cpu(sm, m, trees[m], trees["w4a8 gptq"])
