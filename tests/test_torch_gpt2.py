"""The port's GPT-2 family against the JAX package (and HF transformers), on
the CPU.

A small GPT-2 at hd 64 (hidden 128, 2 heads, so MHA with groups 1, 2 layers,
intermediate 512, vocab 512, 64 learned positions). Every layernorm weight,
layernorm bias, projection bias and the position table are seeded non-zero
(numpy), so a dropped bias, a swapped ``c_attn`` split or a missing position
add shows. Parameters cross as numpy bytes (`convert.params_from_numpy`);
the JAX package runs its CPU paths (XLA). Tolerances:

* configs, fused and loaded leaves, the chip helper's layout: exact;
* ``layer_norm``: f32 within 1e-6; bf16 within one bf16 ulp (``rsqrt`` may
  differ by an ulp between XLA and torch, and the result rounds to bf16);
* logits in f32 (forward, decode_step at 1 and 2-16 tokens; dense, int8
  and paged caches): atol 1e-4 (float rounding only, one op order); on an
  int8 cache the codes may move one quantum on under 1% of the cache and
  the logits within 2e-2 (Queue C: an int8 cache cascades one code flip);
* W8A8 and W4A8: logits within 2e-3 of the largest |logit| where no
  act-quant code moved (the top-2 gaps, asserted, stay far above it);
* greedy ids (``generate``, the engine): identical, on prompts whose top-2
  logit gaps the test checks to be above the f32 tolerance;
* HF ``GPT2LMHeadModel``: 1e-4 in f32.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import PagedKVCache as JPagedKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import GPT2Config as JGPT2Config
from metalchat_tpu.config import config_from_dict as jconfig_from_dict
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.io.loaders import load_gpt2_params as jload_gpt2_params
from metalchat_tpu.io.safetensors import SafetensorsDocument as JDocument
from metalchat_tpu.io.safetensors import save_safetensors
from metalchat_tpu.models.decode import decode_step as jdecode_step
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.models.transformer import make_rope_tables as jrope_tables
from metalchat_tpu.ops import xla as xops
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import GPT2Config, config_from_dict, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.engine.generate import generate
from metalchat_tpu_torch.io import load_gpt2_params, open_safetensors
from metalchat_tpu_torch.models import decode as tdecode
from metalchat_tpu_torch.models import decode_step, forward, fuse_projections
from metalchat_tpu_torch.models.transformer import init_random_params
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.quant.quantize import QuantizedTensor, quantize_params
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

# GPT-2 XL's config.json (openai-community/gpt2-xl), the widths chip_smoke.py runs.
HF_XL = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "n_embd": 1600,
         "n_head": 25, "n_layer": 48, "n_positions": 1024, "n_ctx": 1024,
         "vocab_size": 50257, "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new",
         "bos_token_id": 50256, "eos_token_id": 50256}
HF_SMALL = {"model_type": "gpt2", "n_embd": 128, "n_head": 2, "n_layer": 2,
            "n_positions": 64, "n_inner": None, "vocab_size": 512,
            "layer_norm_epsilon": 1e-5, "bos_token_id": 511, "eos_token_id": 511}
MAX_SEQ = 64
F32_ATOL = 1e-4
INT8_KV_ATOL = 2e-2


def _configs():
    return jconfig_from_dict(HF_SMALL), config_from_dict(HF_SMALL)


def _numpy_params(seed=0):
    """Dense f32 GPT-2 parameters from a numpy seed: layernorm weights
    around 1 with non-zero biases, projections scaled by fan-in, non-zero
    projection biases, a non-zero position table, the head tied."""
    rng = np.random.default_rng(seed)
    h, f, L, V = 128, 512, 2, 512

    def w(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)

    def small(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    embed = small(V, h, scale=0.3)
    layers = {
        "attn_norm": 1 + small(L, h), "attn_norm_b": small(L, h),
        "ffn_norm": 1 + small(L, h), "ffn_norm_b": small(L, h),
        "wq": w(L, h, h, fan=h), "wk": w(L, h, h, fan=h), "wv": w(L, h, h, fan=h),
        "wq_b": small(L, h), "wk_b": small(L, h), "wv_b": small(L, h),
        "wo": w(L, h, h, fan=h), "wo_b": small(L, h),
        "w1": w(L, h, f, fan=h), "w1_b": small(L, f),
        "w2": w(L, f, h, fan=f), "w2_b": small(L, h),
    }
    jcfg, _ = _configs()
    rope = {k: np.asarray(v) for k, v in jrope_tables(jcfg, MAX_SEQ).items()}
    return {"embed": embed, "pos_emb": small(MAX_SEQ, h, scale=0.3), "layers": layers,
            "final_norm": 1 + small(h), "final_norm_b": small(h),
            "lm_head": np.ascontiguousarray(embed.T), "rope": rope}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _configs()
    tree = _numpy_params()
    return jcfg, cfg, _jax_tree(tree), params_from_numpy(tree, "cpu"), tree


# -- config -----------------------------------------------------------------------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("hf", [HF_XL, HF_SMALL], ids=["xl", "small"])
def test_config_from_dict_matches_jax(hf, tmp_path):
    port, ref = config_from_dict(hf), jconfig_from_dict(hf)
    assert isinstance(port, GPT2Config)
    assert _fields(port) == _fields(ref)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert _fields(load_config(tmp_path / "config.json")) == _fields(ref)


def test_gpt2_xl_widths():
    cfg = config_from_dict(HF_XL)
    assert (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (1600, 25, 25, 64)
    assert (cfg.num_layers, cfg.intermediate_size, cfg.max_seq_len) == (48, 6400, 1024)
    assert (cfg.norm_type, cfg.position_embedding, cfg.ffn_type, cfg.use_bias,
            cfg.hidden_act) == ("layernorm", "learned", "mlp", True, "gelu_tanh")
    # By architecture name alone, as the JAX dispatch reads it.
    arch = {k: v for k, v in HF_XL.items() if k != "model_type"}
    assert isinstance(config_from_dict(arch), GPT2Config)


def test_directly_built_config_keeps_jax_defaults():
    """`GPT2Config(...)` built directly keeps ModelConfig's Llama-like
    switches in both packages (tests/test_decode_path.py builds one so)."""
    kw = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4, head_dim=32, max_seq_len=128)
    assert _fields(GPT2Config(**kw)) == _fields(JGPT2Config(**kw))
    assert GPT2Config(**kw).norm_type == "rmsnorm"


# -- layer_norm -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 128)) * 3 + 0.5).astype(np.float32)
    w = (1 + rng.standard_normal(128) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(xops.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                      jnp.asarray(b, jdt), eps=1e-5).astype(jnp.float32))
    got = ops.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                         torch.from_numpy(b).to(tdt), eps=1e-5).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:  # one bf16 ulp of the value
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


# -- the model ----------------------------------------------------------------------

def _caches(kind, jcfg, cfg, batch=1):
    if kind == "dense":
        return (JKVCache.create(jcfg, batch, MAX_SEQ, dtype=jnp.float32),
                KVCache.create(cfg, batch, MAX_SEQ, dtype=torch.float32, device="cpu"))
    if kind == "int8":
        return (JQKVCache.create(jcfg, batch, MAX_SEQ),
                QuantizedKVCache.create(cfg, batch, MAX_SEQ, device="cpu"))
    table = np.array([[3, 0, 6, 1, 7, 2, 5, 4]], np.int32)  # shuffled pages
    jc = JPagedKVCache.create(jcfg, num_pages=8, page_size=8, max_slots=1)
    jc = jc.__class__(jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale,
                      jnp.asarray(table), jc.lengths)
    tc = PagedKVCache.create(cfg, num_pages=8, page_size=8, max_slots=1, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    return jc, tc


# A 20-token prefill (flash), single tokens, a 5-token window (decode_step's
# 2-16 token branch on dense caches; a paged cache takes the layer route as
# in JAX), single tokens again.
STEPS = [(0, 20), (20, 1), (21, 1), (22, 1), (23, 5), (28, 1), (29, 1)]


def _step_logits(fwd, params, cache, cfg, tokens, to_tokens, steps=STEPS):
    out = []
    for start, n in steps:
        logits, cache = fwd(params, cache, to_tokens(tokens[:, start:start + n]), start, cfg)
        out.append(np.asarray(logits))
    return out, cache


def _int8_codes(cache):
    names = ("k_pages", "v_pages") if hasattr(cache, "k_pages") else ("k", "v")
    return [np.asarray(getattr(cache, n)).astype(np.int32) for n in names]


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_forward_logits_f32(small, kind):
    jcfg, cfg, jparams, params, _ = small
    tokens = np.random.default_rng(5).integers(0, 512, (1, 30))
    jc, tc = _caches(kind, jcfg, cfg)
    want, jc = _step_logits(jforward, jparams, jc, jcfg, tokens, jnp.asarray)
    got, tc = _step_logits(forward, params, tc, cfg, tokens, torch.from_numpy)
    atol = F32_ATOL
    if kind != "dense":
        for g, w_ in zip(_int8_codes(tc), _int8_codes(jc)):
            moved = np.abs(g - w_)
            assert moved.max() <= 1 and moved.mean() < 0.01, moved.sum()
        atol = INT8_KV_ATOL
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=atol)


def test_biases_and_positions_reach_the_logits(small):
    """The premise of every comparison here: each bias leaf, the layernorm
    biases and the position table move the logits (zeroing any one moves
    them by far more than the tolerance). Not ``wk_b``: a key bias adds
    q·b to every score of a query alike, which the softmax cancels (HF's
    GPT-2 carries it all the same, and both packages add it)."""
    _, cfg, _, params, tree = small
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, 12)))

    def logits(tr):
        cache = KVCache.create(cfg, 1, MAX_SEQ, dtype=torch.float32, device="cpu")
        return forward(params_from_numpy(tr, "cpu"), cache, tokens, 0, cfg)[0].numpy()

    base = logits(tree)
    for name in ("wq_b", "wv_b", "wo_b", "w1_b", "w2_b", "attn_norm_b", "ffn_norm_b"):
        layers = dict(tree["layers"], **{name: np.zeros_like(tree["layers"][name])})
        assert np.abs(logits(dict(tree, layers=layers)) - base).max() > 100 * F32_ATOL, name
    for name in ("pos_emb", "final_norm_b"):
        assert np.abs(logits(dict(tree, **{name: np.zeros_like(tree[name])})) - base).max() \
            > 100 * F32_ATOL, name


@pytest.mark.parametrize("s", [1, 2, 7, 16])
@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_decode_step_matches_jax(small, s, kind):
    """`decode_step` itself at one token and at 2-16-token windows, two rows
    at per-row offsets, after a 20-token prefill, against JAX's."""
    jcfg, cfg, jparams, params, _ = small
    rng = np.random.default_rng(s)
    prompt = rng.integers(0, 512, (2, 20))
    jc, tc = _caches(kind, jcfg, cfg, batch=2)
    _, jc = jforward(jparams, jc, jnp.asarray(prompt), 0, jcfg)
    _, tc = forward(params, tc, torch.from_numpy(prompt), 0, cfg)
    win = rng.integers(0, 512, (2, s))
    start = np.array([20, 17], np.int32) if s == 1 else 20
    want, jc = jdecode_step(jparams, jc, jnp.asarray(win, jnp.int32), jnp.asarray(start), jcfg)
    got, tc = decode_step(params, tc, torch.from_numpy(win),
                          torch.as_tensor(start) if s == 1 else start, cfg)
    atol = F32_ATOL if kind == "dense" else INT8_KV_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_fuse_projections_with_biases_matches_jax(small):
    jcfg, cfg, jparams, params, _ = small
    want = jax_tree_to_numpy(jfuse(jparams, jcfg))
    fused = fuse_projections(params, cfg)
    assert set(fused["layers"]) == set(want["layers"])
    assert "wqkv_b" in fused["layers"] and "w13" not in fused["layers"]
    assert "w1" in fused["layers"] and "w1_b" in fused["layers"]
    for name in ("wqkv", "wqkv_b"):
        np.testing.assert_array_equal(fused["layers"][name].numpy(), want["layers"][name])
    tokens = np.random.default_rng(5).integers(0, 512, (1, 30))
    for p in (params, fused):
        got, _ = _step_logits(forward, p, _caches("dense", jcfg, cfg)[1], cfg, tokens,
                              torch.from_numpy)
        ref, _ = _step_logits(jforward, jparams, _caches("dense", jcfg, cfg)[0], jcfg, tokens,
                              jnp.asarray)
        for g, w_ in zip(got, ref):
            np.testing.assert_allclose(g, w_, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_matches_jax(small, bits):
    """W8A8 / W4A8 per-channel, wqkv fused, int8 KV: prefill, one-token and
    5-token windows. No act-quant code moves here: the logits agree within
    2e-3 of the largest, and the greedy ids wherever the top-2 gap is twice
    that (at least 4 positions of 5)."""
    jcfg, cfg, jparams, _, _ = small
    jq = jfuse(jquantize_params(jparams, bits=bits, group_size=None, act_bits=8), jcfg)
    params = params_from_numpy(jax_tree_to_numpy(jq), "cpu")
    assert isinstance(params["layers"]["wqkv"], QuantizedTensor) and "wqkv_b" in params["layers"]
    tokens = np.random.default_rng(6).integers(0, 512, (1, 30))
    jc, tc = _caches("int8", jcfg, cfg)
    want, _ = _step_logits(jforward, jq, jc, jcfg, tokens, jnp.asarray)
    got, _ = _step_logits(forward, params, tc, cfg, tokens, torch.from_numpy)
    sure = []
    for g, w_ in zip(got, want):
        top2 = np.sort(w_, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 4e-3 * np.abs(w_).max()
        np.testing.assert_allclose(g, w_, rtol=0, atol=2e-3 * np.abs(w_).max())
        np.testing.assert_array_equal(g.argmax(-1)[clear], w_.argmax(-1)[clear])
        sure.extend(clear.ravel())
    assert np.mean(sure) >= 0.8


def test_ffn_block_gate_refuses_biases(small):
    """The merged block has no bias adds and an rmsnorm only: refused for
    GPT-2 (no w13 either), as the JAX gate refuses ``use_bias``."""
    _, cfg, _, _, _ = small
    lcfg = cfg.replace(norm_type="rmsnorm", ffn_type="swiglu", position_embedding="rope",
                       num_heads=1, head_dim=128, num_kv_heads=1)
    params = fuse_projections(quantize_params(
        init_random_params(lcfg, dtype=torch.float32, device="cpu"), bits=8, group_size=None,
        act_bits=8), lcfg)
    layers = params["layers"]
    assert tdecode._ffn_block_ok(layers, 1, torch.float32, lcfg.replace(use_bias=False))
    assert not tdecode._ffn_block_ok(layers, 1, torch.float32, lcfg)


def test_init_random_params_gpt2_leaves():
    """The tree's keys and shapes as the JAX package's ``init_random_params``
    makes them: no w3, zero biases, ``final_norm_b``, ``pos_emb`` of
    ``max_seq_len`` rows."""
    jcfg, cfg = _configs()
    for seq in (None, 32):
        want = jax_tree_to_numpy(jinit_random_params(jcfg, dtype=jnp.float32, max_seq_len=seq))
        got = init_random_params(cfg, dtype=torch.float32, max_seq_len=seq, device="cpu")
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for tree_g, tree_w in ((got, want), (got["layers"], want["layers"])):
            for k, v in tree_w.items():
                if isinstance(v, np.ndarray):
                    assert tuple(tree_g[k].shape) == v.shape, k
                    if k.endswith("_b"):
                        assert not tree_g[k].any(), k
        assert got["pos_emb"].shape[0] == (seq or cfg.max_seq_len)


# Prompts (seed, length) whose greedy rollouts keep every top-2 logit gap
# above 1e-3 (checked below): ids, not logits, are compared.
GEN_PROMPTS = [(7, 20), (8, 20)]


def _prompts():
    return np.stack([np.random.default_rng(s).integers(0, 512, n) for s, n in GEN_PROMPTS])


def test_generate_ids_match_jax(small):
    jcfg, cfg, jparams, params, _ = small
    prompt = _prompts()
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompt), max_new_tokens=16,
                                cache=_caches("dense", jcfg, cfg, batch=2)[0]))
    got = generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=16,
                   cache=_caches("dense", jcfg, cfg, batch=2)[1])
    np.testing.assert_array_equal(got.numpy(), want)
    full = np.concatenate([prompt, want[:, :-1]], axis=1)
    logits, _ = jforward(jparams, JKVCache.create(jcfg, 2, MAX_SEQ, dtype=jnp.float32),
                         jnp.asarray(full), 0, jcfg)
    top2 = np.sort(np.asarray(logits)[:, 19:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3


ENGINE_MODES = {"dense": dict(cache_mode="dense"),
                "int8": dict(cache_mode="dense", quantized_kv=True),
                "paged": dict(cache_mode="paged", page_size=8)}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_ids_equal_generate(small, mode):
    """Two greedy requests through the engine (2 slots, chunks of 16, so a
    prompt is chunked and its last chunk padded) give `generate`'s ids on
    the same cache kind (dense f32 or int8; paged is int8 too)."""
    _, cfg, _, params, _ = small
    prompt = _prompts()
    want = generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=16,
                    quantized_kv=mode != "dense").numpy()
    engine = ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=MAX_SEQ,
                                      prefill_chunk=16, decode_burst=4, **ENGINE_MODES[mode])
    reqs = [Request(prompt=p.tolist(), max_new_tokens=16) for p in prompt]
    out = engine.run(reqs)
    assert [out[r.request_id].tokens for r in reqs] == want.tolist()


def test_pos_emb_clamps_like_jax(small):
    """Positions past the position table read its last row, as JAX's
    gather clamps: a 24-row table under a 64-position cache, a prefill of
    20 tokens and windows that run to position 35."""
    jcfg, cfg, _, _, tree = small
    tree = dict(tree, pos_emb=tree["pos_emb"][:24])
    jparams, params = _jax_tree(tree), params_from_numpy(tree, "cpu")
    tokens = np.random.default_rng(11).integers(0, 512, (1, 36))
    steps = [(0, 20), (20, 5), (25, 1), (26, 1), (27, 9)]
    jc, tc = _caches("dense", jcfg, cfg)
    want, _ = _step_logits(jforward, jparams, jc, jcfg, tokens, jnp.asarray, steps)
    got, _ = _step_logits(forward, params, tc, cfg, tokens, torch.from_numpy, steps)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=F32_ATOL)
    # A layer-route window past the table too (17 tokens, 20 → 36).
    jc, tc = _caches("dense", jcfg, cfg)
    steps = [(0, 19), (19, 17)]
    want, _ = _step_logits(jforward, jparams, jc, jcfg, tokens, jnp.asarray, steps)
    got, _ = _step_logits(forward, params, tc, cfg, tokens, torch.from_numpy, steps)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=F32_ATOL)


def test_params_from_numpy_carries_gpt2_trees(small):
    """GPT-2's leaves cross unchanged: ``pos_emb``, every ``_b`` leaf,
    ``final_norm_b``, and a row-quantized embedding whose QuantizedTensor
    keeps ``transposed=False``."""
    jcfg, _, jparams, _, tree = small
    jq = jquantize_params(jfuse(jparams, jcfg), bits=4, group_size=32, quantize_embed=True)
    want = jax_tree_to_numpy(jq)
    got = params_from_numpy(want, "cpu")
    for name in ("pos_emb", "final_norm_b"):
        np.testing.assert_array_equal(got[name].numpy(), tree[name])
    for name in ("wqkv_b", "wo_b", "w1_b", "w2_b", "attn_norm_b", "ffn_norm_b"):
        np.testing.assert_array_equal(got["layers"][name].numpy(), want["layers"][name])
    emb = got["embed"]
    assert isinstance(emb, QuantizedTensor) and not emb.transposed and emb.bits == 4
    np.testing.assert_array_equal(emb.q.numpy(), want["embed"]["q"])
    np.testing.assert_array_equal(emb.scales.numpy(), want["embed"]["scales"])


# -- the loader and HF transformers ----------------------------------------------

@pytest.fixture(scope="module")
def hf_gpt2(tmp_path_factory):
    from transformers import GPT2Config as HFConfig
    from transformers import GPT2LMHeadModel

    hf_cfg = HFConfig(vocab_size=512, n_positions=64, n_embd=128, n_layer=2, n_head=2,
                      activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
                      attn_pdrop=0.0)
    torch.manual_seed(0)
    model = GPT2LMHeadModel(hf_cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # HF initialises biases to zero and norms to one
        for name, p in model.named_parameters():
            if name.endswith(".bias") or "ln_" in name or "wpe" in name:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    tensors = {name.replace("transformer.", ""): p.detach().numpy()
               for name, p in model.state_dict().items()
               if not name.endswith(".attn.bias") and not name.endswith(".attn.masked_bias")
               and name != "lm_head.weight"}
    path = tmp_path_factory.mktemp("gpt2") / "model.safetensors"
    save_safetensors(path, tensors)
    return model, path


@pytest.mark.parametrize("seq", [6, 24])
def test_load_gpt2_params_matches_transformers(hf_gpt2, seq):
    model, path = hf_gpt2
    jcfg, cfg = _configs()
    params = load_gpt2_params(open_safetensors(path), cfg, dtype=torch.float32, device="cpu")
    want_tree = jax_tree_to_numpy(jload_gpt2_params(JDocument.open(path), jcfg,
                                                    dtype=jnp.float32))
    assert set(params) == set(want_tree) and set(params["layers"]) == set(want_tree["layers"])
    for name, leaf in want_tree["layers"].items():
        np.testing.assert_array_equal(params["layers"][name].numpy(), leaf, err_msg=name)
    for name in ("embed", "pos_emb", "final_norm", "final_norm_b", "lm_head"):
        np.testing.assert_array_equal(params[name].numpy(), want_tree[name], err_msg=name)
    assert params["lm_head"].is_contiguous()
    tokens = np.random.default_rng(seq).integers(0, 512, (1, seq))
    with torch.no_grad():
        expect = model(torch.from_numpy(tokens)).logits.numpy()
    cache = KVCache.create(cfg, 1, MAX_SEQ, dtype=torch.float32, device="cpu")
    logits, _ = forward(params, cache, torch.from_numpy(tokens), 0, cfg)
    np.testing.assert_allclose(logits.numpy(), expect, rtol=0, atol=1e-4)


# -- the card's GPT-2 XL tree, built without quantize_params --------------------------

def test_chip_gpt2_tree_has_quantize_params_layout():
    """`chip_smoke.make_gpt2_params` draws the W8A8 tree on the device (no
    host quantize of 1.47 B weights): at a small size its leaves have the
    keys, shapes, orientation, bits and dtypes of `quantize_params` +
    `fuse_projections` over `init_random_params`, and every bias, layernorm
    leaf and the position table are non-zero."""
    _, cfg = _configs()
    got = chip_smoke.make_gpt2_params(cfg, torch.device("cpu"), seed=0)
    dense = init_random_params(cfg, dtype=torch.bfloat16, device="cpu")
    want = fuse_projections(quantize_params(dense, bits=8, group_size=None, act_bits=8), cfg)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])

    def same_layout(g, w, what):
        if isinstance(w, QuantizedTensor):
            assert isinstance(g, QuantizedTensor), what
            assert (g.bits, g.group_size, g.transposed, g.act_bits) == (
                w.bits, w.group_size, w.transposed, w.act_bits), what
            for a, b in ((g.q, w.q), (g.scales, w.scales)):
                assert (a.shape, a.dtype) == (b.shape, b.dtype), what
        elif isinstance(w, dict):
            for k in w:
                same_layout(g[k], w[k], k)
        else:
            assert (g.shape, g.dtype) == (w.shape, w.dtype), what

    same_layout(got, want, "params")
    for name, leaf in got["layers"].items():
        if not isinstance(leaf, QuantizedTensor):
            assert bool((leaf != 0).all()), name
    for name in ("pos_emb", "final_norm", "final_norm_b"):
        assert bool((got[name] != 0).all()), name
    assert got["lm_head"].is_contiguous()
