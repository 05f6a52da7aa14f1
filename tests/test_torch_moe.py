"""The port's Mixtral sparse-MoE family against the JAX package (and HF
transformers), on the CPU.

A small Mixtral (hidden 256, intermediate 512, 2 layers, 4 query heads over
2 kv heads, hd 64, 8 experts, top-2, vocab 512, 256 positions). Inputs come
from a numpy seed; parameters cross as numpy bytes
(`convert.params_from_numpy`). The JAX package runs its CPU paths: XLA, and
its Pallas kernels in interpret mode where the test asks for them
(``pallas_interpret``, as ``tests/test_moe.py`` does). Tolerances:

* configs: field by field, exact;
* `moe_ffn` (dense scheme at 24 tokens, dispatch at 64, capacity factor 2.0
  and 0.5): f32 outputs within 1e-5 of the largest |output|; the router's
  probabilities and gates within 1e-6, expert ids exact; the load-balancing
  loss within 1e-6; the dropped (token, choice) set equal to the one the JAX
  dispatch realises (each token's output is that of its kept choices);
* the indexed matvec's plain version against the JAX kernel (interpreted)
  with a traced index into a flattened ``[L·E, out, k]`` stack: int32
  accumulators exact, outputs within one f32 ulp;
* ``decode_step`` on a W4A8 MoE, int8 KV, at 1 and 2 rows (the sparse
  formulation: T·K ≤ E/2) and 3 rows (dense over experts), against the JAX
  ``decode_step`` with its kernels interpreted: 4 greedy steps with equal
  tokens, logits within 1e-3 in norm (the bound ``tests/test_moe.py`` sets
  between the JAX package's own two routes); dense f32 params within 2e-4;
* ``forward(fast_decode=False)`` at one token (the scan route: rows 6 and 7
  interpreted on the JAX side) on a dense f32, an int8 and a paged cache:
  logits within 1e-4 of the largest, int8 codes exact, their scales within
  2e-6 (absmax / 127 of K/V rows whose f32 products the two packages sum in
  another order, a few ulps apart);
* greedy ids of `generate` and of the paged engine: identical;
* the loader on a checkpoint written by the JAX package's ``save_params``:
  every leaf exact; HF ``MixtralForCausalLM``: logits within 1e-4.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import PagedKVCache as JPagedKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import MixtralConfig as JMixtralConfig
from metalchat_tpu.config import ModelConfig as JModelConfig
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from metalchat_tpu.engine.serving import Request as JRequest
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.loaders import save_params as jsave_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.io.safetensors import save_safetensors
from metalchat_tpu.models import moe as jmoe
from metalchat_tpu.models.decode import decode_step as jdecode_step
from metalchat_tpu.models.decode import supports_fast_decode as jsupports
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.models.transformer import make_rope_tables as jrope_tables
from metalchat_tpu.ops.a8_matvec_pallas import quant_matvec_stacked as j_raw
from metalchat_tpu.ops.a8_matvec_pallas import quant_matvec_stacked_fused as j_fused
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import MixtralConfig, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.engine.generate import generate
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.models import decode as tdecode
from metalchat_tpu_torch.models import moe
from metalchat_tpu_torch.models import transformer as ttransformer
from metalchat_tpu_torch.models.fuse import fuse_projections
from metalchat_tpu_torch.models.transformer import forward, init_random_params
from metalchat_tpu_torch.ops.a8_matvec import (
    act_quantize,
    quant_matvec_stacked_fused,
    quant_matvec_stacked_plain,
)
from metalchat_tpu_torch.quant.quantize import QuantizedTensor, quantize_params
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10_000.0,
             max_seq_len=256, tie_word_embeddings=False, num_experts=8,
             num_experts_per_tok=2)
MAX_SEQ = 256
H, F, E, L, V = 256, 512, 8, 2, 512
W4A8 = dict(bits=4, group_size=None, act_bits=8)


def _configs(**kw):
    return JMixtralConfig(**{**SMALL, **kw}), MixtralConfig(**{**SMALL, **kw})


def _numpy_params(seed=0):
    """Dense f32 Mixtral parameters from a numpy seed: projections and the
    router scaled by fan-in (the router's logits near unit spread, so
    routing is decided), norms around one."""
    rng = np.random.default_rng(seed)
    nh, nkv, hd = 4, 2, 64

    def w(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)

    def norm(*shape):
        return (1.0 + rng.standard_normal(shape) * 0.1).astype(np.float32)

    layers = {
        "attn_norm": norm(L, H), "ffn_norm": norm(L, H),
        "wq": w(L, H, nh * hd, fan=H), "wk": w(L, H, nkv * hd, fan=H),
        "wv": w(L, H, nkv * hd, fan=H), "wo": w(L, nh * hd, H, fan=nh * hd),
        "router": w(L, H, E, fan=H),
        "w1": w(L, E, H, F, fan=H), "w3": w(L, E, H, F, fan=H), "w2": w(L, E, F, H, fan=F),
    }
    jcfg, _ = _configs()
    rope = {k: np.asarray(v) for k, v in jrope_tables(jcfg, MAX_SEQ).items()}
    return {"embed": (rng.standard_normal((V, H)) * 0.5).astype(np.float32),
            "layers": layers, "final_norm": norm(H), "lm_head": w(H, V, fan=H),
            "rope": rope}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _configs()
    tree = _numpy_params()
    return jcfg, cfg, _jax_tree(tree), params_from_numpy(tree, "cpu"), tree


@pytest.fixture(scope="module")
def w4a8(small):
    """The small Mixtral quantized W4A8 by the JAX package (wqkv fused, the
    experts left apart as the JAX fuse does), and its bytes in the port."""
    jcfg, cfg, jparams, _, _ = small
    jq = jfuse(jquantize_params(jparams, **W4A8), jcfg)
    return jq, params_from_numpy(jax_tree_to_numpy(jq), "cpu")


@pytest.fixture
def pallas_interpret(monkeypatch):
    from metalchat_tpu import ops

    monkeypatch.setenv("METALCHAT_TPU_PALLAS_INTERPRET", "1")
    ops.use_pallas.cache_clear()
    yield
    ops.use_pallas.cache_clear()


# -- configs ----------------------------------------------------------------------

def _assert_fields_equal(port, ref):
    """Every field of the port's config equals the JAX one's; the JAX
    fields the port leaves out are at ModelConfig's defaults (inert)."""
    names = {f.name for f in dataclasses.fields(port)}
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    defaults = JModelConfig()
    for f in dataclasses.fields(ref):
        if f.name not in names:
            assert getattr(ref, f.name) == getattr(defaults, f.name), f.name


def test_mixtral_8x7b_preset_matches_jax():
    cfg = MixtralConfig.mixtral_8x7b()
    _assert_fields_equal(cfg, JMixtralConfig.mixtral_8x7b())
    _assert_fields_equal(MixtralConfig.mixtral_8x7b(sliding_window=4096),
                         JMixtralConfig.mixtral_8x7b(sliding_window=4096))
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.intermediate_size, cfg.vocab_size) == (4096, 32, 8, 2, 14336, 32000)


HF_MIXTRAL = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_local_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "max_position_embeddings": 32768, "bos_token_id": 1,
    "eos_token_id": 2, "tie_word_embeddings": False, "sliding_window": None,
}


@pytest.mark.parametrize("window", [None, 4096])
def test_load_config_mixtral_json(window, tmp_path):
    """`load_config` on a Mixtral config.json equals the JAX package's,
    field by field; a sliding window, when set, covers every layer."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(HF_MIXTRAL, sliding_window=window)))
    got = load_config(path)
    assert isinstance(got, MixtralConfig)
    _assert_fields_equal(got, jload_config(path))
    assert [got.layer_window(l) for l in (0, 31)] == [-1 if window is None else window] * 2
    preset = MixtralConfig.mixtral_8x7b()
    if window is None:
        assert got == preset


def test_load_config_dispatch_by_architecture(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"architectures": ["MixtralForCausalLM"], "hidden_size": 64,
                                "num_attention_heads": 4, "num_local_experts": 4}))
    got = load_config(path)
    assert isinstance(got, MixtralConfig) and got.num_experts == 4 and got.head_dim == 16


# -- moe_ffn ----------------------------------------------------------------------

def _layer(tree, l=0):
    return {n: tree["layers"][n][l] for n in ("router", "w1", "w3", "w2")}


CASES = {"dense": (3, 8, 2.0), "dispatch": (4, 16, 2.0), "dispatch-drops": (4, 16, 0.5)}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(small, case):
    _, _, _, _, tree = small
    b, s, factor = CASES[case]
    jcfg, cfg = _configs(expert_capacity_factor=factor)
    x = np.random.default_rng(11).standard_normal((b, s, H)).astype(np.float32)
    layer = _layer(tree)
    want, want_aux = jmoe.moe_ffn(jnp.asarray(x), _jax_tree(layer), jcfg)
    got, aux = moe.moe_ffn(torch.from_numpy(x), params_from_numpy(layer, "cpu"), cfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_route_matches_jax(small):
    _, _, _, _, tree = small
    jcfg, cfg = _configs()
    xt = np.random.default_rng(12).standard_normal((64, H)).astype(np.float32)
    router = tree["layers"]["router"][1]
    jp, jg, ji = (np.asarray(a) for a in jmoe._route(jnp.asarray(xt), jnp.asarray(router),
                                                      jcfg))
    p, g, i = moe.route(torch.from_numpy(xt), torch.from_numpy(router), cfg)
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), ji)


def test_dispatch_drops_the_same_pairs(small):
    """At capacity factor 0.5 the port's dropped (token, choice) pairs are
    the ones the JAX dispatch drops: a token with no pair dropped gets the
    dense (exact) output from JAX's dispatch, one with both dropped gets
    zeros, one with a single pair dropped gets exactly its kept choice's
    gated expert output."""
    _, _, _, _, tree = small
    jcfg, cfg = _configs(expert_capacity_factor=0.5)
    xt = np.random.default_rng(13).standard_normal((64, H)).astype(np.float32)
    layer = _layer(tree, 1)
    jlayer = _jax_tree(layer)
    jx = jnp.asarray(xt)
    disp = np.asarray(jmoe._moe_dispatch(jx, jlayer, jcfg)[0])
    dense = np.asarray(jmoe._moe_dense(jx, jlayer, jcfg)[0])
    experts = np.asarray(jmoe._expert_mlp(jnp.broadcast_to(jx[None], (E, *xt.shape)), jlayer,
                                          jcfg))  # [E, T, H]
    _, gates, idx = moe.route(torch.from_numpy(xt), torch.from_numpy(layer["router"]), cfg)
    cap = moe.capacity(64, cfg)
    assert cap == 8
    _, kept = moe.dispatch_slots(idx, E, cap)
    kept, gates, idx = kept.numpy(), gates.numpy(), idx.numpy()
    n_kept = kept.sum(axis=1)
    assert (n_kept < 2).sum() > 0 and (n_kept == 2).sum() > 0
    tol = 1e-5 * np.abs(dense).max()
    for t in range(64):
        if n_kept[t] == 2:
            want = dense[t]
        else:
            want = sum(gates[t, j] * experts[idx[t, j], t] for j in range(2) if kept[t, j])
            want = np.zeros(H, np.float32) if n_kept[t] == 0 else want
        assert np.abs(disp[t] - want).max() <= tol, (t, kept[t])
    got = moe._moe_dispatch(torch.from_numpy(xt), params_from_numpy(layer, "cpu"), cfg)[0]
    assert np.abs(got.numpy() - disp).max() <= tol


# -- row 1 with a device index: the plain version against the JAX kernel --------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 2])
def test_indexed_matvec_plain_matches_jax(bits, rows):
    """A flattened [L·E, out, k] stack (L = 2, E = 8) addressed by a traced
    index on the JAX side and a 0-d int32 tensor on the port's."""
    rng = np.random.default_rng(20 + bits + rows)
    n, out_f, in_f = L * E, 512, 256
    k = in_f // 2 if bits == 4 else in_f
    p = rng.integers(-128, 128, (n, out_f, k), dtype=np.int8)
    s = (rng.random((n, 1, out_f)) * 0.01 + 0.001).astype(np.float32)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    fused = jax.jit(lambda x, p, s, i: j_fused(x, p, s, i, bits=bits, interpret=True))
    raw = jax.jit(lambda xq, p, i: j_raw(xq, p, i, bits=bits, interpret=True))
    xq, _ = act_quantize(torch.from_numpy(x))
    for i in (0, 5, n - 1):
        index = torch.tensor(i, dtype=torch.int32)
        want_acc = np.asarray(raw(jnp.asarray(xq.numpy()), jnp.asarray(p), jnp.int32(i)))
        np.testing.assert_array_equal(
            quant_matvec_stacked_plain(xq, torch.from_numpy(p), index, bits=bits).numpy(),
            want_acc)
        want = np.asarray(fused(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), jnp.int32(i)))
        got = quant_matvec_stacked_fused(torch.from_numpy(x), torch.from_numpy(p),
                                         torch.from_numpy(s), index, bits=bits).numpy()
        assert (np.abs(got - want) <= np.spacing(np.abs(want))).all(), i


# -- the decode step ----------------------------------------------------------------

def _rollout(fwd, params, cache, b, steps, to_tokens, to_pos):
    """Greedy steps from tokens 1..b at position 0: (tokens [steps, b], the
    logits of every step)."""
    tok = np.arange(1, b + 1)[:, None]
    toks, logits = [], []
    for i in range(steps):
        out, cache = fwd(params, cache, to_tokens(tok), to_pos(np.full((b,), i, np.int32)))
        out = np.asarray(out)
        logits.append(out)
        tok = out[:, -1].argmax(-1)[:, None]
        toks.append(tok[:, 0])
    return np.asarray(toks), logits


def _routes_seen(monkeypatch):
    """The index types `_expert_linear_l` passes to the matvec: tensors
    (sparse) or ints (dense over experts)."""
    seen = []
    real = tdecode.quant_matvec_stacked_fused

    def spy(x, p, s, layer, **kw):
        seen.append("tensor" if torch.is_tensor(layer) else "int")
        return real(x, p, s, layer, **kw)

    monkeypatch.setattr(tdecode, "quant_matvec_stacked_fused", spy)
    return seen


@pytest.mark.parametrize("b", [1, 2, 3])
def test_decode_step_w4a8_matches_jax(small, w4a8, pallas_interpret, monkeypatch, b):
    """W4A8 experts through the stacked matvec over the flattened (layer,
    expert) index, int8 KV: 1 and 2 rows take the sparse formulation (a
    device index a routed pair), 3 rows the dense one (host indices)."""
    jcfg, cfg, _, _, _ = small
    jq, params = w4a8
    assert isinstance(params["layers"]["w1"], QuantizedTensor)
    assert params["layers"]["w1"].q.shape == (L, E, F, H // 2)
    assert "w13" not in params["layers"] and "wqkv" in params["layers"]
    jstep = jax.jit(lambda p, c, t, s: jdecode_step(p, c, t, s, jcfg))
    want_t, want = _rollout(jstep, jq, JQKVCache.create(jcfg, b, MAX_SEQ), b, 4, jnp.asarray,
                            jnp.asarray)
    seen = _routes_seen(monkeypatch)
    got_t, got = _rollout(lambda p, c, t, s: tdecode.decode_step(p, c, t, s, cfg), params,
                          QuantizedKVCache.create(cfg, b, MAX_SEQ, device="cpu"), b, 4,
                          torch.from_numpy, torch.from_numpy)
    # 4 steps: wqkv and wo a layer at host indices, and the experts.
    sparse = b * cfg.num_experts_per_tok <= E // 2
    experts = 3 * L * 4 * (cfg.num_experts_per_tok * b if sparse else E)
    assert seen.count("tensor") == (experts if sparse else 0)
    assert seen.count("int") == 2 * L * 4 + (0 if sparse else experts)
    np.testing.assert_array_equal(got_t, want_t)
    for g, w_ in zip(got, want):
        assert np.linalg.norm(g - w_) / np.linalg.norm(w_) < 1e-3


@pytest.mark.parametrize("b", [1, 3])
def test_decode_step_dense_f32_matches_jax(small, b):
    jcfg, cfg, jparams, params, _ = small
    jstep = jax.jit(lambda p, c, t, s: jdecode_step(p, c, t, s, jcfg))
    want_t, want = _rollout(jstep, jparams, JKVCache.create(jcfg, b, MAX_SEQ, dtype=jnp.float32),
                            b, 4, jnp.asarray, jnp.asarray)
    got_t, got = _rollout(lambda p, c, t, s: tdecode.decode_step(p, c, t, s, cfg), params,
                          KVCache.create(cfg, b, MAX_SEQ, dtype=torch.float32, device="cpu"),
                          b, 4, torch.from_numpy, torch.from_numpy)
    np.testing.assert_array_equal(got_t, want_t)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=2e-4, atol=2e-4)


def test_supports_fast_decode_matches_jax(small, w4a8):
    jcfg, cfg, jparams, params, _ = small
    jq, tq = w4a8
    caches = {"dense": (JKVCache.create(jcfg, 1, 32, dtype=jnp.float32),
                        KVCache.create(cfg, 1, 32, dtype=torch.float32, device="cpu")),
              "paged": (JPagedKVCache.create(jcfg, num_pages=4, page_size=16, max_slots=1),
                        PagedKVCache.create(cfg, num_pages=4, page_size=16, max_slots=1,
                                            device="cpu"))}
    flat = {**jax_tree_to_numpy(jparams), "layers": {
        **jax_tree_to_numpy(jparams)["layers"],
        "w1": np.asarray(jparams["layers"]["w1"]).reshape(L * E, H, F)}}
    trees = [(jparams, params), (jq, tq), (_jax_tree(flat), params_from_numpy(flat, "cpu"))]
    for jc, tc in caches.values():
        for s in (1, 5, 16, 17):
            for jp, tp in trees:
                want = jsupports(jp, jc, jcfg, jnp.zeros((1, s), jnp.int32))
                assert tdecode.supports_fast_decode(tp, tc, cfg, torch.zeros(1, s)) == want
    # The paged windows it refuses take the layer route; decode_step says so.
    with pytest.raises(ValueError, match="one token a row on a paged cache"):
        tdecode.decode_step(params, caches["paged"][1], torch.zeros((1, 5), dtype=torch.long),
                            0, cfg)


# -- the scan route: forward(fast_decode=False) at one token (rows 6 and 7) ------------

def _caches(kind, jcfg, cfg, b=2):
    if kind == "dense":
        return (JKVCache.create(jcfg, b, MAX_SEQ, dtype=jnp.float32),
                KVCache.create(cfg, b, MAX_SEQ, dtype=torch.float32, device="cpu"))
    if kind == "int8":
        return JQKVCache.create(jcfg, b, MAX_SEQ), QuantizedKVCache.create(cfg, b, MAX_SEQ,
                                                                          device="cpu")
    table = np.array([[2, 0], [3, 1]], np.int32)  # pages of 128, two a row, shuffled
    jc = JPagedKVCache.create(jcfg, num_pages=4, page_size=128, max_slots=b)
    jc = jc.__class__(jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale, jnp.asarray(table),
                      jc.lengths)
    tc = PagedKVCache.create(cfg, num_pages=4, page_size=128, max_slots=b, device="cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    return jc, tc


def _cache_arrays(cache):
    names = [f.name for f in dataclasses.fields(cache) if f.name not in ("page_table",
                                                                          "lengths")]
    return {n: np.asarray(getattr(cache, n)) for n in names}


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_scan_route_one_token_matches_jax(small, pallas_interpret, monkeypatch, kind):
    """A 20-token prefill, then 4 single tokens with ``fast_decode=False``:
    the cache written first, then the one-layer read-only kernel (row 6 on a
    dense cache of 256 positions, row 7 on pages of 128), interpreted on the
    JAX side, the plain versions on the port's; the MoE FFN through
    `moe_ffn` (the dense scheme)."""
    jcfg, cfg, jparams, params, _ = small
    tokens = np.random.default_rng(14).integers(0, V, (2, 24))
    calls = []
    for name in ("decode_attention", "decode_attention_quantized", "paged_decode_attention"):
        real = getattr(ttransformer, name)
        monkeypatch.setattr(ttransformer, name,
                            lambda *a, _real=real, _name=name, **kw: (calls.append(_name),
                                                                      _real(*a, **kw))[1])
    jc, tc = _caches(kind, jcfg, cfg)
    want, got = [], []
    for start, n in ((0, 20), (20, 1), (21, 1), (22, 1), (23, 1)):
        w_, jc = jforward(jparams, jc, jnp.asarray(tokens[:, start:start + n]), start, jcfg,
                          fast_decode=False)
        g, tc = forward(params, tc, torch.from_numpy(tokens[:, start:start + n]), start, cfg,
                        fast_decode=False)
        want.append(np.asarray(w_))
        got.append(g.numpy())
    kernel = {"dense": "decode_attention", "int8": "decode_attention_quantized",
              "paged": "paged_decode_attention"}[kind]
    assert calls == [kernel] * (4 * L)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-4 * np.abs(w_).max())
    jarr, tarr = _cache_arrays(jc), _cache_arrays(tc)
    for n, a in tarr.items():
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, jarr[n], err_msg=n)
        elif kind == "dense":
            np.testing.assert_allclose(a, jarr[n], rtol=0, atol=1e-5, err_msg=n)
        else:
            # absmax / 127 of K/V rows that the two packages' f32 products
            # sum in another order: a few ulps apart.
            np.testing.assert_allclose(a, jarr[n], rtol=2e-6, atol=0, err_msg=n)


def test_scan_route_skips_kernels_off_block(small):
    """The JAX block conditions: a dense cache of 200 positions (no block of
    128 or 256 divides it) and pages of 16 take the reference attention at
    one token; the logits match the kernel route's."""
    _, cfg, _, params, _ = small
    tokens = torch.from_numpy(np.random.default_rng(15).integers(0, V, (1, 21)))
    for off_block in (QuantizedKVCache.create(cfg, 1, 200, device="cpu"),
                      PagedKVCache.create(cfg, num_pages=16, page_size=16, max_slots=1,
                                          device="cpu")):
        assert ttransformer._attend_one(torch.zeros(1, 1, 4, 64), off_block, 0,
                                        torch.zeros(1, dtype=torch.int64), cfg) is None
    ref = QuantizedKVCache.create(cfg, 1, MAX_SEQ, device="cpu")
    other = QuantizedKVCache.create(cfg, 1, 200, device="cpu")
    for c in (ref, other):
        forward(params, c, tokens[:, :20], 0, cfg)
    a, _ = forward(params, ref, tokens[:, 20:], 20, cfg, fast_decode=False)
    b, _ = forward(params, other, tokens[:, 20:], 20, cfg, fast_decode=False)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-4 * a.abs().max().item())


# -- generation and serving ------------------------------------------------------------

def test_generate_ids_match_jax(small):
    jcfg, cfg, jparams, params, _ = small
    prompt = np.random.default_rng(16).integers(0, V, (2, 12))
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompt), max_new_tokens=10,
                                cache=JKVCache.create(jcfg, 2, 32, dtype=jnp.float32)))
    got = generate(params, cfg, torch.from_numpy(prompt), max_new_tokens=10,
                   cache=KVCache.create(cfg, 2, 32, dtype=torch.float32, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    # The premise: no near tie on the way (teacher-forced JAX logits).
    full = np.concatenate([prompt, want[:, :-1]], axis=1)
    logits, _ = jforward(jparams, JKVCache.create(jcfg, 2, MAX_SEQ, dtype=jnp.float32),
                         jnp.asarray(full), 0, jcfg)
    top2 = np.sort(np.asarray(logits)[:, 11:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3


SERVE = dict(max_slots=2, max_seq_len=MAX_SEQ, prefill_chunk=16, decode_burst=4,
             prefill_interleave=1, cache_mode="paged", page_size=16)


def test_serving_engine_paged_matches_jax(small, w4a8):
    """Three greedy requests (prompts of 5, 40 and 11 tokens) through both
    engines on the W4A8 Mixtral, paged int8 KV, 2 slots: every decode step
    has 1 or 2 rows (the sparse formulation), the 40-token prompt's chunks
    take the dense MoE scheme; tokens, finish reasons and counters equal."""
    jcfg, cfg, _, _, _ = small
    jq, params = w4a8
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 40, 11)]
    jengine = JEngine(jq, jcfg, **SERVE)
    want = list(jengine.run([JRequest(prompt=p, max_new_tokens=8) for p in prompts]).values())
    engine = ContinuousBatchingEngine(params, cfg, **SERVE)
    got = list(engine.run([Request(prompt=p, max_new_tokens=8) for p in prompts]).values())
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == [c.finish_reason for c in want] == ["length"] * 3
    assert engine.counters == dict(jengine.counters)
    assert engine.allocator.free_pages == engine.num_pages


# -- parameters: random init, quantization, fusion, the loader ---------------------------

def test_init_random_params_tree_matches_jax():
    jcfg, cfg = _configs()
    want = jinit_random_params(jcfg, seed=0, dtype=jnp.float32, max_seq_len=64)
    got = init_random_params(cfg, seed=0, dtype=torch.float32, max_seq_len=64, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat_w}
    got_shapes = {}
    for top, node in got.items():
        items = node.items() if isinstance(node, dict) else [(None, node)]
        for name, t in items:
            key = f"['{top}']" + ("" if name is None else f"['{name}']")
            got_shapes[key] = tuple(t.shape)
    assert got_shapes == shapes
    assert got["layers"]["w1"].std().item() == pytest.approx(0.02, rel=0.05)


def test_quantize_params_expert_stacks_match_jax(small, w4a8):
    """`quantize_params` on the [L, E, in, out] expert leaves: a 4-D act8
    QuantizedTensor, q [L, E, out, in/2] transposed, bytes and scales equal
    to the JAX package's; the router stays dense."""
    _, cfg, _, params, _ = small
    jq, from_jax = w4a8
    mine = fuse_projections(quantize_params(params, **W4A8), cfg)
    for name in ("w1", "w3", "w2", "wqkv", "wo"):
        a, b = mine["layers"][name], from_jax["layers"][name]
        assert a.transposed and b.transposed and a.act_bits == 8
        np.testing.assert_array_equal(a.q.numpy(), b.q.numpy(), err_msg=name)
        np.testing.assert_array_equal(a.scales.numpy(), b.scales.numpy(), err_msg=name)
    assert mine["layers"]["w2"].q.shape == (L, E, H, F // 2)
    assert not isinstance(mine["layers"]["router"], QuantizedTensor)
    assert set(mine["layers"]) == set(jq["layers"])


def test_loader_reads_jax_saved_checkpoint(small, tmp_path):
    """A Mixtral checkpoint written by the JAX package's ``save_params``
    (``block_sparse_moe.gate`` and ``experts.N.w{1,2,3}``): the port's
    loader gives the JAX loader's params, leaf by leaf."""
    jcfg, cfg, jparams, _, _ = small
    save_safetensors(tmp_path / "model.safetensors", jsave_params(jparams, jcfg))
    want = jax_tree_to_numpy(jload_params(jopen(tmp_path), jcfg, dtype=jnp.float32,
                                          max_seq_len=MAX_SEQ))
    got = load_params(open_safetensors(tmp_path), cfg, dtype=torch.float32,
                      max_seq_len=MAX_SEQ, device="cpu")
    assert set(got["layers"]) == set(want["layers"])
    for name, leaf in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), leaf, err_msg=name)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    assert got["layers"]["w2"].shape == (L, E, F, H)


@pytest.mark.parametrize("seq", [8, 40])
def test_mixtral_matches_transformers(tmp_path, seq):
    """The port's `load_params` reads an HF Mixtral checkpoint written here
    and its `forward` matches `MixtralForCausalLM` in f32: 8 tokens take the
    decode path (dense over experts), 40 the layer route (the dispatch
    scheme, no drop at 4 experts and factor 2)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=150, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=64, rope_theta=1_000_000.0, num_local_experts=4,
        num_experts_per_tok=2, rms_norm_eps=1e-5, sliding_window=None,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(3)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # decided routing: router weights of unit fan-in spread
        for name, p in model.named_parameters():
            if name.endswith("gate.weight"):
                p.normal_(0.0, 64 ** -0.5)
    tensors = {name: p.detach().numpy() for name, p in model.state_dict().items()
               if "rotary_emb" not in name}
    save_safetensors(tmp_path / "model.safetensors", tensors)
    (tmp_path / "config.json").write_text(json.dumps(
        dict(hf_cfg.to_dict(), architectures=["MixtralForCausalLM"])))
    cfg = load_config(tmp_path / "config.json")
    assert isinstance(cfg, MixtralConfig) and cfg.num_experts == 4
    params = load_params(open_safetensors(tmp_path), cfg, dtype=torch.float32,
                         max_seq_len=64, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(18).integers(0, 150, (1, seq)))
    with torch.no_grad():
        want = model(tokens).logits.numpy()
    got, _ = forward(params, KVCache.create(cfg, 1, 64, dtype=torch.float32, device="cpu"),
                     tokens, 0, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
