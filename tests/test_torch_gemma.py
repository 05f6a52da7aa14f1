"""The port's Gemma-3 family against the JAX package (and HF transformers),
on the CPU.

A small Gemma-3 at head_dim 256 (hidden 256, 3 layers, 2 query heads over 1
kv head, intermediate 512, vocab 512, window 8, every 3rd layer global, so
layers 0-1 slide and layer 2 is global). Inputs come from a numpy seed;
parameters cross as numpy bytes (`convert.params_from_numpy`). The JAX
package runs on its CPU paths (XLA; its Pallas kernels in interpret mode
where a test calls them). Tolerances:

* configs and int8 cache codes: exact; rope tables within 1e-6 (cos/sin
  of the same f32 angles); the new rows' scales within one ulp (the JAX
  kernels interpreted on the CPU land absmax / 127 one ulp off the true
  division in some rows, Queue C);
* rms_norm with the offset and gelu-tanh: 1e-6 relative (f32, one op order);
* the plain versions of rows 3, 4 and 8 at hd 256 with windows:
  rtol = atol = 1e-5 (online against one-pass softmax, summation order);
* prefill and decode logits in f32 (dense, int8 and paged caches):
  atol 1e-4 (float rounding only: both packages run the same op order);
* W8A8 fused: logits within 2e-3 of the largest |logit| where no act-quant
  code moved, which is every position here (the test asserts it by the
  top-2 gaps: a one-quantum flip is the known drift of Queue C);
* greedy ids (generate, the paged engine): identical, on prompts whose
  top-2 logit gaps the test checks to be above the f32 tolerance;
* HF `Gemma3ForCausalLM`: rtol = atol = 5e-3, as the JAX package's own
  parity test (`tests/test_hf_parity.py`).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import PagedKVCache as JPagedKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import Gemma3Config as JGemma3Config
from metalchat_tpu.config import ModelConfig as JModelConfig
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from metalchat_tpu.engine.serving import Request as JRequest
from metalchat_tpu.io.safetensors import save_safetensors
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import make_rope_tables as jrope_tables
from metalchat_tpu.ops import xla as xops
from metalchat_tpu.ops.decode_attention_pallas import (
    decode_attention_update_quantized_stacked as j_decode_update,
)
from metalchat_tpu.ops.flash_attention_pallas import flash_attention as j_flash
from metalchat_tpu.ops.paged_attention_pallas import (
    paged_decode_attention_update_stacked as j_paged_update,
)
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import (
    Gemma3Config,
    GPT2Config,
    LlamaConfig,
    MixtralConfig,
    ModelConfig,
    load_config,
)
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.engine.generate import generate
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.models import decode as tdecode
from metalchat_tpu_torch.models.fuse import fuse_projections
from metalchat_tpu_torch.models.transformer import forward, make_rope_tables
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.ops.decode_attention import decode_attention_update_quantized_stacked
from metalchat_tpu_torch.ops.flash_attention import flash_attention
from metalchat_tpu_torch.ops.paged_attention import paged_decode_attention_update_stacked
from metalchat_tpu_torch.quant.quantize import init_random_quantized_params
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
             num_heads=2, num_kv_heads=1, head_dim=256, sliding_window=8,
             sliding_window_pattern=3, max_seq_len=64, embedding_scale=256.0 ** 0.5)
MAX_SEQ = 64
F32_ATOL = 1e-4


def _configs():
    return JGemma3Config.gemma3_1b(**SMALL), Gemma3Config.gemma3_1b(**SMALL)


def _numpy_params(seed=0):
    """Dense f32 Gemma parameters from a numpy seed: random norm weights
    (around the offset's zero), projections scaled by fan-in, a tied head."""
    rng = np.random.default_rng(seed)
    h, f, nh, nkv, hd, L, V = 256, 512, 2, 1, 256, 3, 512

    def w(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)

    def norm(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    embed = (rng.standard_normal((V, h)) * 0.05).astype(np.float32)
    layers = {
        "attn_norm": norm(L, h), "ffn_norm": norm(L, h),
        "post_attn_norm": norm(L, h), "post_ffn_norm": norm(L, h),
        "q_norm": norm(L, hd), "k_norm": norm(L, hd),
        "wq": w(L, h, nh * hd, fan=h), "wk": w(L, h, nkv * hd, fan=h),
        "wv": w(L, h, nkv * hd, fan=h), "wo": w(L, nh * hd, h, fan=nh * hd),
        "w1": w(L, h, f, fan=h), "w3": w(L, h, f, fan=h), "w2": w(L, f, h, fan=f),
    }
    jcfg, _ = _configs()
    rope = {k: np.asarray(v) for k, v in jrope_tables(jcfg, MAX_SEQ).items()}
    return {"embed": embed, "layers": layers, "final_norm": norm(h),
            "lm_head": np.ascontiguousarray(embed.T), "rope": rope}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _configs()
    tree = _numpy_params()
    return jcfg, cfg, _jax_tree(tree), params_from_numpy(tree, "cpu"), tree


# -- configs --------------------------------------------------------------------

def _assert_fields_equal(port, ref):
    """Every field of the port's config equals the JAX one's; the JAX
    fields the port leaves out are at ModelConfig's defaults (inert)."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(port)}
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    defaults = JModelConfig()
    for f in dataclasses.fields(ref):
        if f.name not in names:
            assert getattr(ref, f.name) == getattr(defaults, f.name), f.name


@pytest.mark.parametrize("preset", ["gemma3_1b", "gemma3_4b"])
def test_gemma3_presets_match_jax(preset):
    kw = dict(max_seq_len=1024)
    _assert_fields_equal(getattr(Gemma3Config, preset)(**kw),
                         getattr(JGemma3Config, preset)(**kw))


HF_1B = {
    "architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text",
    "vocab_size": 262144, "hidden_size": 1152, "intermediate_size": 6912,
    "num_hidden_layers": 26, "num_attention_heads": 4, "num_key_value_heads": 1,
    "head_dim": 256, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "sliding_window": 512, "sliding_window_pattern": 6,
    "max_position_embeddings": 32768, "query_pre_attn_scalar": 256,
    "bos_token_id": 2, "eos_token_id": [1, 106], "tie_word_embeddings": True,
}
HF_4B_NESTED = {
    "architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
    "eos_token_id": [1, 106],
    "text_config": {"hidden_size": 2560, "intermediate_size": 10240,
                    "num_hidden_layers": 34, "num_attention_heads": 8,
                    "num_key_value_heads": 4, "head_dim": 256, "sliding_window": 1024,
                    "vocab_size": 262208, "max_position_embeddings": 131072,
                    "query_pre_attn_scalar": 256, "rope_local_base_freq": 10000.0},
}


@pytest.mark.parametrize("hf", [HF_1B, HF_4B_NESTED], ids=["1b", "4b-nested"])
def test_load_config_gemma_json(hf, tmp_path):
    """`load_config` on a Gemma config.json (flat, and a multimodal one with
    a nested text_config) equals the JAX package's, field by field."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(hf))
    got = load_config(path)
    assert isinstance(got, Gemma3Config)
    _assert_fields_equal(got, jload_config(path))


def test_load_config_dispatch(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"model_type": "llama", "hidden_size": 64,
                                "num_attention_heads": 4}))
    assert isinstance(load_config(path), LlamaConfig)
    path.write_text(json.dumps({"model_type": "mixtral"}))
    assert isinstance(load_config(path), MixtralConfig)
    path.write_text(json.dumps({"model_type": "gpt2"}))
    assert isinstance(load_config(path), GPT2Config)
    path.write_text(json.dumps({"model_type": "bert"}))
    with pytest.raises(ValueError, match="bert"):
        load_config(path)


@pytest.mark.parametrize("window,pattern", [(8, 3), (8, 1), (8, 0), (None, 6)])
def test_layer_is_global_and_window(window, pattern):
    kw = dict(sliding_window=window, sliding_window_pattern=pattern, num_layers=7)
    port, ref = ModelConfig(**kw), JModelConfig(**kw)
    for l in range(7):
        assert port.layer_is_global(l) == ref.layer_is_global(l)
        assert port.layer_window(l) == (-1 if ref.layer_is_global(l) else window)


# -- ops ------------------------------------------------------------------------

def test_rms_norm_offset_and_gelu_tanh():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32) * 3
    w = rng.standard_normal(256).astype(np.float32) * 0.1
    want = np.asarray(xops.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, offset=1.0))
    got = ops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6, offset=1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(ops.gelu_tanh(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((4, 256)).astype(np.float32)
    mats = [rng.standard_normal(s).astype(np.float32) * 0.1
            for s in ((256, 64), (256, 64), (64, 256))]
    want = np.asarray(xops.swiglu(*(jnp.asarray(a) for a in (h, *mats)), "gelu_tanh"))
    got = ops.swiglu(*(torch.from_numpy(a) for a in (h, *mats)), "gelu_tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_rope_tables_match_jax():
    jcfg, cfg = _configs()
    want = jrope_tables(jcfg, MAX_SEQ)
    got = make_rope_tables(cfg, MAX_SEQ, device="cpu")
    assert set(got) == set(want) == {"cos", "sin", "cos_local", "sin_local"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


# -- rows 3, 4 and 8 at hd 256 (plain versions against Pallas interpret) --------

HD = 256
SCALE = HD ** -0.5


@pytest.mark.parametrize("window", [None, 24, -1])
def test_decode_update_hd256_matches(window):
    rng = np.random.default_rng(2)
    L, B, nkv, T, nh = 2, 3, 1, 64, 4
    k, v = (rng.integers(-127, 128, (L, B, nkv, T, HD), dtype=np.int8) for _ in range(2))
    ks, vs = ((rng.random((L, B, nkv, T)) * 0.01).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, nh, HD)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, nkv, HD)).astype(np.float32) for _ in range(2))
    lengths = np.array([1, 40, 64], np.int32)  # under the window, across it, full
    outs = j_decode_update(*(jnp.asarray(a) for a in (q, kn, vn, k, v, ks, vs)), 1,
                           jnp.asarray(lengths), scale=SCALE, window=window, block_t=16,
                           interpret=True)
    want = [np.asarray(o) for o in outs]
    got = decode_attention_update_quantized_stacked(
        *(torch.from_numpy(a.copy()) for a in (q, kn, vn, k, v, ks, vs)), 1,
        torch.from_numpy(lengths), scale=SCALE, window=window)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    for g, w_ in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), w_)
    # Scales: the interpreted kernel's absmax / 127 lands one ulp off the
    # true division in some rows at hd 256, as the paged one does.
    for g, w_ in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=2e-7, atol=0)


@pytest.mark.parametrize("start,window", [(0, None), (0, 8), (13, 8), (5, -1)])
def test_flash_hd256_matches(start, window):
    rng = np.random.default_rng(3)
    B, S, nh, nkv, T = 2, 32, 4, 1, 48
    q = rng.standard_normal((B, S, nh, HD)).astype(np.float32)
    k, v = (rng.standard_normal((B, nkv, T, HD)).astype(np.float32) for _ in range(2))
    sp = np.full((B,), start, np.int32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sp),
                              scale=SCALE, window=window, block_q=16, block_k=16,
                              interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          start, scale=SCALE, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 20])
def test_paged_update_hd256_matches(window):
    """Pages exact; scales within the interpreted kernel's one ulp (its
    absmax times a rounded 1/127, `tests/test_torch_paged.py`); outputs of
    the rows whose write page is live within 1e-5."""
    rng = np.random.default_rng(4)
    L, B, nh, nkv, psize, mp, P = 2, 3, 4, 1, 16, 4, 9
    kp, vp = (rng.integers(-127, 128, (L, nkv, P + 1, psize, HD), dtype=np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((L, P + 1, nkv, psize)) * 0.01).astype(np.float32)
              for _ in range(2))
    table = np.full((B, mp), P, np.int32)
    table[0, :3] = [4, 0, 7]
    table[1, :4] = [2, 8, 1, 5]
    lengths = np.array([40, 64, 1], np.int32)  # the last row at the sentinel
    q = rng.standard_normal((B, nh, HD)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, nkv, HD)).astype(np.float32) for _ in range(2))
    outs = j_paged_update(*(jnp.asarray(a) for a in (q, kn, vn, kp, vp, ks, vs, table)),
                          jnp.asarray(lengths), 1, scale=SCALE, window=window,
                          interpret=True)
    want = [np.asarray(o) for o in outs]
    got = paged_decode_attention_update_stacked(
        *(torch.from_numpy(a.copy()) for a in (q, kn, vn, kp, vp, ks, vs, table, lengths)),
        1, scale=SCALE, window=window)
    live = slice(0, 2)
    np.testing.assert_allclose(got[0].numpy()[live], want[0][live], rtol=1e-5, atol=1e-5)
    for g, w_ in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy()[:, :, :P], w_[:, :, :P])
    for g, w_ in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy()[:, :P], w_[:, :P], rtol=2e-7, atol=0)


# -- the model: prefill and decode ------------------------------------------------

def _caches(kind, jcfg, cfg):
    """(JAX cache, port cache) of one row and MAX_SEQ positions."""
    if kind == "dense":
        return (JKVCache.create(jcfg, 1, MAX_SEQ, dtype=jnp.float32),
                KVCache.create(cfg, 1, MAX_SEQ, dtype=torch.float32, device="cpu"))
    if kind == "int8":
        return JQKVCache.create(jcfg, 1, MAX_SEQ), QuantizedKVCache.create(cfg, 1, MAX_SEQ,
                                                                          device="cpu")
    table = np.array([[3, 0, 6, 1, 7, 2, 5, 4]], np.int32)  # shuffled pages
    jc = JPagedKVCache.create(jcfg, num_pages=8, page_size=8, max_slots=1)
    jc = jc.__class__(jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale,
                      jnp.asarray(table), jc.lengths)
    tc = PagedKVCache.create(cfg, num_pages=8, page_size=8, max_slots=1, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    return jc, tc


# Steps: a 20-token prefill (flash over the cache; window 8 drops positions),
# single tokens, a 5-token window (the 2-16 token branch's window mask; a
# paged cache takes JAX's scan path there), single tokens again.
STEPS = [(0, 20), (20, 1), (21, 1), (22, 1), (23, 5), (28, 1), (29, 1)]


def _step_logits(fwd, params, cache, cfg, tokens, to_tokens):
    out = []
    for start, n in STEPS:
        logits, cache = fwd(params, cache, to_tokens(tokens[:, start:start + n]), start, cfg)
        out.append(np.asarray(logits))
    return out, cache


# An int8 cache adds one source of difference: a K/V element that the two
# packages compute an ulp apart (another op order upstream) and that sits at
# a rounding boundary gets codes one quantum apart, and the later layers'
# inputs then move by that quantum's effect, which moves more of their codes
# at their boundaries (here one V code in layer 0, then 0.4% of the codes of
# layers 1-2, all at positions past the window). Codes stay within one
# quantum, on under 1% of the cache; logits within 2e-2 (0.0071 measured).
INT8_KV_ATOL = 2e-2


def _int8_codes(cache):
    names = ("k_pages", "v_pages") if hasattr(cache, "k_pages") else ("k", "v")
    return [np.asarray(getattr(cache, n)).astype(np.int32) for n in names]


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_prefill_and_decode_logits_f32(small, kind):
    jcfg, cfg, jparams, params, _ = small
    tokens = np.random.default_rng(5).integers(0, 512, (1, 30))
    jc, tc = _caches(kind, jcfg, cfg)
    want, jc = _step_logits(jforward, jparams, jc, jcfg, tokens, lambda t: jnp.asarray(t))
    got, tc = _step_logits(forward, params, tc, cfg, tokens, lambda t: torch.from_numpy(t))
    atol = F32_ATOL
    if kind != "dense":
        for g, w_ in zip(_int8_codes(tc), _int8_codes(jc)):
            moved = np.abs(g - w_)
            assert moved.max() <= 1 and moved.mean() < 0.01, moved.sum()
        atol = INT8_KV_ATOL
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=atol)


def test_w8a8_fused_logits(small):
    """W8A8 per-channel, wqkv and w13 fused, int8 KV: the decode path's
    matvecs (the rmsnorm prologue at offset 1) and the prefill's. No
    act-quant code moves here: both sides' logits agree to 2e-3 of the
    largest, far inside every top-2 gap."""
    jcfg, cfg, jparams, _, _ = small
    jq = jfuse(jquantize_params(jparams, bits=8, group_size=None, act_bits=8), jcfg)
    params = params_from_numpy(jax_tree_to_numpy(jq), "cpu")
    assert set(params["layers"]) >= {"wqkv", "w13", "q_norm", "k_norm", "post_attn_norm",
                                     "post_ffn_norm"}
    tokens = np.random.default_rng(6).integers(0, 512, (1, 30))
    jc, tc = _caches("int8", jcfg, cfg)
    want, _ = _step_logits(jforward, jq, jc, jcfg, tokens, lambda t: jnp.asarray(t))
    got, _ = _step_logits(forward, params, tc, cfg, tokens, lambda t: torch.from_numpy(t))
    for g, w_ in zip(got, want):
        top2 = np.sort(w_, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 4e-3 * np.abs(w_).max()
        np.testing.assert_allclose(g, w_, rtol=0, atol=2e-3 * np.abs(w_).max())
        np.testing.assert_array_equal(g.argmax(-1), w_.argmax(-1))


def test_ffn_block_gate_refuses_post_norms(small):
    """The merged block has no post-FFN norm: the gate refuses a config with
    post-norms, as the JAX gate does, and takes the same leaves without."""
    cfg = small[1].replace(num_heads=1)  # wo's input as wide as the hidden state
    params = fuse_projections(init_random_quantized_params(
        cfg, bits=8, group_size=None, act_bits=8, max_seq_len=MAX_SEQ, device="cpu"), cfg)
    layers = params["layers"]
    assert not tdecode._ffn_block_ok(layers, 1, torch.bfloat16, cfg)
    assert tdecode._ffn_block_ok(layers, 1, torch.bfloat16, cfg.replace(use_post_norms=False))


def test_random_params_and_fuse_keep_norms(small):
    """`init_random_quantized_params` adds the q/k and post norms as the
    JAX package does; `fuse_projections` leaves them untouched."""
    _, cfg, _, _, _ = small
    params = init_random_quantized_params(cfg, bits=8, group_size=None, act_bits=8,
                                          max_seq_len=MAX_SEQ, device="cpu")
    layers = params["layers"]
    assert layers["q_norm"].shape == layers["k_norm"].shape == (3, 256)
    assert layers["post_attn_norm"].shape == layers["post_ffn_norm"].shape == (3, 256)
    fused = fuse_projections(params, cfg)["layers"]
    for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm", "post_attn_norm",
                 "post_ffn_norm"):
        assert fused[name] is layers[name]
    assert set(params["rope"]) == {"cos", "sin", "cos_local", "sin_local"}


# Prompts (seed, length) whose greedy rollouts have every top-2 logit gap
# above 1e-3 (checked in the tests below): ids, not logits, are compared.
GEN_PROMPTS = [(7, 12), (8, 20)]


def test_generate_ids_dense_f32(small):
    jcfg, cfg, jparams, params, _ = small
    prompt = np.stack([np.random.default_rng(s).integers(0, 512, 20) for s, _ in
                       GEN_PROMPTS])
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompt), max_new_tokens=12))
    got = generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    # The premise: no near tie on the way (teacher-forced JAX logits).
    full = np.concatenate([prompt, want[:, :-1]], axis=1)
    logits, _ = jforward(jparams, JKVCache.create(jcfg, 2, MAX_SEQ, dtype=jnp.float32),
                         jnp.asarray(full), 0, jcfg)
    top2 = np.sort(np.asarray(logits)[:, 19:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3


SERVE = dict(max_slots=2, max_seq_len=MAX_SEQ, prefill_chunk=16, decode_burst=4,
             prefill_interleave=1, cache_mode="paged", page_size=8)


def test_serving_engine_paged_matches_jax(small):
    """Three greedy requests (prompts of 5, 20 and 11 tokens: one chunked at
    16) through both engines on a paged int8 cache, 2 slots: tokens, finish
    reasons and dispatch counters identical."""
    jcfg, cfg, jparams, params, _ = small
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 20, 11)]
    jengine = JEngine(jparams, jcfg, **SERVE)
    want = list(jengine.run([JRequest(prompt=p, max_new_tokens=8) for p in prompts]).values())
    engine = ContinuousBatchingEngine(params, cfg, **SERVE)
    got = list(engine.run([Request(prompt=p, max_new_tokens=8) for p in prompts]).values())
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want] == ["length"] * 3
    assert engine.counters == dict(jengine.counters)
    assert engine.allocator.free_pages == engine.num_pages


@pytest.mark.parametrize("eos", [1, 106])
def test_engine_stops_on_gemma_eos(small, eos):
    """Gemma's two EOS ids (config.eos_token_ids) end a request: with the
    head's columns of the first greedy token and of the EOS id swapped, the
    EOS id comes first and the request finishes with "eos" after it."""
    _, cfg, _, params, tree = small
    assert cfg.eos_token_ids == (1, 106)

    def first(params, **kw):
        req = Request(prompt=[5, 6, 7], max_new_tokens=8, **kw)
        engine = ContinuousBatchingEngine(params, cfg, **SERVE)
        return engine.run([req])[req.request_id]

    free = first(params)
    assert free.finish_reason == "length" and len(free.tokens) == 8
    head = tree["lm_head"].copy()
    head[:, [free.tokens[0], eos]] = head[:, [eos, free.tokens[0]]]
    out = first(params_from_numpy(dict(tree, lm_head=head), "cpu"),
                eos_ids=cfg.eos_token_ids)
    assert out.finish_reason == "eos" and out.tokens == [eos]


# -- HF transformers parity and the loader ----------------------------------------

@pytest.mark.parametrize("seq", [8, 20])
def test_gemma3_matches_transformers(tmp_path, seq):
    """The port's `load_params` reads an HF Gemma-3 checkpoint written here
    (its pre/post feed-forward, post-attention and q/k norm names, the head
    tied to the embedding) and its `forward` matches `Gemma3ForCausalLM`:
    8 tokens take the decode path's window branch, 20 the prefill."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Gemma3TextConfig(
        vocab_size=150, hidden_size=48, intermediate_size=96, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=64, rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        sliding_window=8, sliding_window_pattern=2, rms_norm_eps=1e-6,
        query_pre_attn_scalar=16, attention_bias=False, attn_implementation="eager")
    torch.manual_seed(2)
    model = transformers.Gemma3ForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # HF inits the norms at zero: give them values
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    tensors = {name: p.detach().numpy() for name, p in model.state_dict().items()
               if "rotary_emb" not in name and name != "lm_head.weight"}
    save_safetensors(tmp_path / "model.safetensors", tensors)
    # As a checkpoint's config.json has them (transformers keeps the
    # pattern private and leaves architectures unset on a bare config).
    hf_json = dict(hf_cfg.to_dict(), architectures=["Gemma3ForCausalLM"],
                   sliding_window_pattern=2)
    (tmp_path / "config.json").write_text(json.dumps(hf_json))

    cfg = load_config(tmp_path / "config.json")
    assert isinstance(cfg, Gemma3Config) and cfg.sliding_window_pattern == 2
    params = load_params(open_safetensors(tmp_path), cfg, dtype=torch.float32,
                         max_seq_len=64, device="cpu")
    assert torch.equal(params["layers"]["ffn_norm"][1], torch.from_numpy(
        tensors["model.layers.1.pre_feedforward_layernorm.weight"]))
    assert torch.equal(params["lm_head"], params["embed"].T)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(0, 150, (1, seq)))
    with torch.no_grad():
        want = model(tokens).logits.numpy()
    got, _ = forward(params, KVCache.create(cfg, 1, 64, dtype=torch.float32, device="cpu"),
                     tokens, 0, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
