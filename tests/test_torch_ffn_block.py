"""The merged FFN block (ops/ffn_block.py, the plain version of
csrc/ffn_block.cu) and `decode_step(..., ffn_block=True)` against the JAX
package, f32 on the CPU.

Tolerances:

* the block against ``ffn_block_stacked`` (interpret mode), the cases of
  tests/test_ffn_block.py: 1e-5 relative (plus 1e-6 of the largest
  output). The f32 activation differs by an ulp between torch's silu/gelu
  and XLA's; that moves h's absmax, so its scale and every output, by a few
  ulps. An int8 code of the normed x2 or of h may also move by one quantum
  where the value sits on a rounding boundary (the f32 mean and the
  activation differ by an ulp). Such rows are found from the port's own
  ratios (value / scale within 1e-4 of a half) and are held to four
  quanta of h's effect on the output, ``4·sx_h·s_w2·qmax``;
* a decode step with the merged block against the JAX decode step with
  ``METALCHAT_FFN_BLOCK=1`` (Pallas in interpret mode): logits within 1e-5,
  int8 cache codes equal, cache scales within 1e-6 relative (the new K/V
  rows come out of the fused norm prologue, whose reduction order moves
  them by an ulp: ROADMAP Queue C known behaviour 1).
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.ops.ffn_block_pallas import ffn_block_stacked as j_ffn
from metalchat_tpu_torch.ops import a8_matvec as am
from metalchat_tpu_torch.ops import ffn_block as fb
from torch_port_util import ffn_weights_np, near_rounding_boundary

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

jq = importlib.import_module("metalchat_tpu.quant.quantize")


CASES = [(8, 128, 256, act, batch, 0.0) for act in ("silu", "gelu_tanh") for batch in (1, 8)]
CASES += [(4, 256, 512, act, batch, 0.0) for act in ("silu", "gelu_tanh") for batch in (1, 8)]
CASES += [(8, 128, 256, "gelu_tanh", 2, 1.0), (4, 256, 512, "silu", 2, 1.0)]


@pytest.mark.parametrize("bits,H,F,act,batch,offset", CASES, ids=str)
def test_ffn_block_plain_matches_pallas(bits, H, F, act, batch, offset):
    rng = np.random.default_rng(42)
    L, eps = 3, 1e-5
    w = ffn_weights_np(rng, L, H, F, bits)
    attn = rng.standard_normal((batch, H)).astype(np.float32)
    x = rng.standard_normal((batch, H)).astype(np.float32)
    jw = dict(w, norm_w=w["norm_w"][:, None, :])
    for layer in (0, L - 1):
        want = np.asarray(j_ffn(jnp.asarray(attn), jnp.asarray(x), *map(jnp.asarray, (
            jw["wo_q"], jw["wo_s"], jw["norm_w"], jw["w13_q"], jw["w13_s"], jw["w2_q"],
            jw["w2_s"])), layer, bits=bits, act=act, eps=eps, offset=offset, interpret=True))
        tw = {k: torch.from_numpy(v) for k, v in w.items()}
        ta, tx = torch.from_numpy(attn), torch.from_numpy(x)
        scratch = {}
        got = fb.ffn_block_stacked(ta, tx, *tw.values(), layer, bits=bits, act=act, eps=eps,
                                   offset=offset, scratch=scratch).numpy()
        # Rows whose norm or h codes sit on a rounding boundary are held to
        # four quanta of h's effect; every other row to the ulp-level limit.
        xf = scratch["x2"]
        normed = xf * torch.rsqrt(xf.square().mean(1, keepdim=True) + eps) * (
            offset + tw["norm_w"][layer])
        _, sx_n = am.prologue(xf, tw["norm_w"][layer], eps, offset)
        _, sx_h = am.act_quantize(scratch["h"])
        tie = near_rounding_boundary(normed, sx_n) | near_rounding_boundary(scratch["h"], sx_h)
        np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        quanta = 4 * sx_h.numpy() * w["w2_s"][layer].reshape(1, -1) * (8 if bits == 4 else 127)
        assert np.all(np.abs(got[tie] - want[tie]) <= quanta[tie] + 1e-5 * np.abs(want[tie]))


def test_ffn_block_scratch_and_phases_compose():
    """The phases (the chip check's units) compose to the block, and the
    scratch holds the block's own x2 and h."""
    rng = np.random.default_rng(1)
    w = {k: torch.from_numpy(v) for k, v in ffn_weights_np(rng, 2, 128, 256, 4).items()}
    attn, x = (torch.from_numpy(rng.standard_normal((3, 128)).astype(np.float32))
               for _ in range(2))
    scratch = {}
    out = fb.ffn_block_stacked(attn, x, *w.values(), 1, bits=4, act="silu", eps=1e-5,
                               scratch=scratch)
    x2 = fb.wo_stage(attn, x, w["wo_q"][1], w["wo_s"][1], bits=4)
    h = fb.w13_stage(x2, w["norm_w"][1], w["w13_q"][1], w["w13_s"][1], bits=4, act="silu",
                     eps=1e-5)[0]
    assert torch.equal(scratch["x2"], x2) and torch.equal(scratch["h"], h)
    assert torch.equal(out, fb.w2_stage(h, x2, w["w2_q"][1], w["w2_s"][1], bits=4)[0])


@pytest.mark.parametrize("bad", ["act", "rows", "width", "norm_dtype", "scales"])
def test_ffn_block_gate(bad):
    """What the kernel does not take raises before any launch."""
    meta = dict(device="meta")
    rows, H, F = 2, 64, 96
    if bad == "rows":
        rows = 17
    if bad == "width":
        F = 80
    w = dict(wo_q=torch.empty(1, H, H // 2, dtype=torch.int8, **meta),
             wo_s=torch.empty(1, 1, H, **meta),
             norm_w=torch.empty(1, H, dtype=torch.float16 if bad == "norm_dtype"
                                else torch.bfloat16, **meta),
             w13_q=torch.empty(1, 2 * F, H // 2, dtype=torch.int8, **meta),
             w13_s=torch.empty(1, 1, 2 * F + (bad == "scales"), **meta),
             w2_q=torch.empty(1, H, F // 2, dtype=torch.int8, **meta),
             w2_s=torch.empty(1, 1, H, **meta))
    x = torch.empty(rows, H, dtype=torch.bfloat16, **meta)
    err = ValueError if bad == "act" else RuntimeError
    with pytest.raises(err, match="act in|no kernel for device meta"):
        fb.ffn_block_stacked(x, x, *w.values(), 0, bits=4, act="relu" if bad == "act"
                             else "silu", eps=1e-5)
    assert fb.supported(rows, H, F) == (bad not in ("rows", "width"))


def _decode_cfgs():
    from metalchat_tpu.config import LlamaConfig as JLlama

    kw = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
              num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=128,
              tie_word_embeddings=False)
    from metalchat_tpu_torch.config import LlamaConfig

    return JLlama(**kw), LlamaConfig(**kw)


@pytest.mark.parametrize("bits", [4, 8])
def test_decode_step_with_merged_block_matches_jax(monkeypatch, bits):
    """`decode_step(..., ffn_block=True)` against the JAX decode step with
    METALCHAT_FFN_BLOCK=1 and Pallas in interpret mode (fused act8 params,
    int8 KV, 2 rows at position 4)."""
    from metalchat_tpu import ops as jops
    from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
    from metalchat_tpu.models import decode as jdecode
    from metalchat_tpu.models import init_random_params
    from metalchat_tpu.models.fuse import fuse_projections as jfuse
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.convert import params_from_numpy
    from metalchat_tpu_torch.models import decode
    from torch_port_util import jax_tree_to_numpy

    jcfg, cfg = _decode_cfgs()
    monkeypatch.setenv("METALCHAT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("METALCHAT_FFN_BLOCK", "1")
    jops.use_pallas.cache_clear()
    try:
        params = jfuse(jq.quantize_params(
            init_random_params(jcfg, dtype=jnp.float32, seed=0, max_seq_len=128),
            bits=bits, group_size=None, act_bits=8, scales_dtype=jnp.float32), jcfg)
        tok = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 1)).astype(np.int32)
        calls = []
        orig = jdecode.ffn_block_stacked
        monkeypatch.setattr(jdecode, "ffn_block_stacked",
                            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        want_logits, want_cache = jdecode.decode_step(
            params, JQKVCache.create(jcfg, 2, 128), jnp.asarray(tok), 4, jcfg)
        assert calls, "the JAX merged kernel did not engage"
        want_logits = np.asarray(want_logits)
        want_cache = [np.asarray(t) for t in (want_cache.k, want_cache.v, want_cache.k_scale,
                                              want_cache.v_scale)]
        tree = jax_tree_to_numpy(params)
    finally:
        jops.use_pallas.cache_clear()

    tparams = params_from_numpy(tree, "cpu")
    merged = []
    orig_t = fb.ffn_block_stacked
    monkeypatch.setattr(fb, "ffn_block_stacked",
                        lambda *a, **k: (merged.append(1), orig_t(*a, **k))[1])
    cache = QuantizedKVCache.create(cfg, 2, 128, device="cpu")
    logits, cache = decode.decode_step(tparams, cache, torch.from_numpy(tok).long(), 4, cfg,
                                       ffn_block=True)
    assert len(merged) == cfg.num_layers
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5, atol=1e-5)
    for got, want in zip((cache.k, cache.v), want_cache[:2]):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip((cache.k_scale, cache.v_scale), want_cache[2:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_merged_block_gate_in_decode(monkeypatch):
    """`ffn_block=True` merges only act8 per-channel layers; weight-only
    params and `ffn_block=False` keep the unmerged path."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models import decode
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    _, cfg = _decode_cfgs()
    calls = []
    orig = fb.ffn_block_stacked
    monkeypatch.setattr(fb, "ffn_block_stacked",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    tok = torch.ones(1, 1, dtype=torch.long)
    for quant, flag, want in ((dict(group_size=None, act_bits=8), True, cfg.num_layers),
                              (dict(group_size=None, act_bits=8), False, 0),
                              (dict(group_size=32), True, 0)):
        calls.clear()
        params = fuse_projections(init_random_quantized_params(
            cfg, bits=4, dtype=torch.float32, device="cpu", **quant), cfg)
        decode.decode_step(params, QuantizedKVCache.create(cfg, 1, 128, device="cpu"), tok, 0,
                           cfg, ffn_block=flag)
        assert len(calls) == want, quant


def test_generate_and_engine_take_ffn_block(monkeypatch):
    """`generate` and the engine pass ``ffn_block`` down to every decode
    step. In f32 the merged block computes what the unmerged layer does
    (its f32 activation is the unmerged one's), so the greedy tokens of the
    trained fixture (W4A8) are identical with and without it."""
    import chip_smoke
    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.engine.generate import generate

    params, cfg, fixture = chip_smoke.fixture_params(torch, "cpu", torch.float32)
    prompts = torch.from_numpy(np.load(fixture / "eval_tokens.npy")[:2 * 24]
                               .astype(np.int64).reshape(2, 24))
    calls = []
    orig = fb.ffn_block_stacked
    monkeypatch.setattr(fb, "ffn_block_stacked",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    plain = generate(params, cfg, prompts, max_new_tokens=6, quantized_kv=True)
    assert not calls
    merged = generate(params, cfg, prompts, max_new_tokens=6, quantized_kv=True,
                      ffn_block=True)
    assert len(calls) == 5 * cfg.num_layers  # 5 decode steps after the prefill
    assert torch.equal(merged, plain)
    calls.clear()
    engine = ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=64,
                                      prefill_chunk=32, quantized_kv=True, ffn_block=True)
    done = engine.run([Request(prompt=p.tolist(), max_new_tokens=6) for p in prompts])
    assert calls and [c.tokens for c in done.values()] == plain.tolist()
