"""Model-level parity of the PyTorch port against the JAX package on the
trained fixture (tests/fixtures/pyllama_10m), f32 activations on the CPU
(the JAX CPU backend cannot run bf16 dots).

Parameters cross as numpy bytes (`convert.params_from_numpy`), so both
packages compute on identical weights. The trained fixture, not random
weights, is used for token checks: random toy weights amplify one-quantum
act-quant flips chaotically.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.cache import KVCache as JKVCache, QuantizedKVCache as JQKVCache
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.io.safetensors import save_sharded_safetensors as jsave_sharded
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine.generate import generate
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.models.transformer import forward
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
MAX_SEQ = 128


@pytest.fixture(scope="module")
def jax_fixture():
    cfg = jload_config(FIXTURE / "config.json")
    params = jload_params(jopen(FIXTURE), cfg, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    return cfg, params, tokens


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_loader_matches(jax_fixture, layout, tmp_path):
    """The port's own safetensors reader + loader give the same tree, from
    the fixture's single file and from a sharded copy (index + 4 shards)
    that the JAX package writes."""
    _, jparams, _ = jax_fixture
    want = jax_tree_to_numpy(jparams)
    checkpoint = FIXTURE
    if layout == "sharded":
        doc = jopen(FIXTURE)
        jsave_sharded(tmp_path, {n: doc[n] for n in doc.keys()}, max_shard_bytes=6 << 20)
        assert len(list(tmp_path.glob("model-*-of-00004.safetensors"))) == 4
        checkpoint = tmp_path
    got = load_params(open_safetensors(checkpoint), load_config(FIXTURE / "config.json"),
                      dtype=torch.float32, max_seq_len=MAX_SEQ, device="cpu")
    for name, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), w)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    for name in ("cos", "sin"):
        np.testing.assert_allclose(got["rope"][name].numpy(), want["rope"][name],
                                   rtol=1e-5, atol=1e-5)


def test_dense_prefill_and_decode_logits(jax_fixture):
    """64-token prefill then 8 decode steps: logits within 1e-4."""
    jcfg, jparams, tokens = jax_fixture
    prompt, steps = tokens[None, :64], tokens[64:72]
    cache = JKVCache.create(jcfg, 1, MAX_SEQ, dtype=jnp.float32)
    logits, cache = jforward(jparams, cache, jnp.asarray(prompt), 0, jcfg)
    want = [np.asarray(logits)]
    for i, t in enumerate(steps):
        logits, cache = jforward(jparams, cache, jnp.asarray([[t]]), 64 + i, jcfg)
        want.append(np.asarray(logits))
    tree = jax_tree_to_numpy(jparams)

    cfg = load_config(FIXTURE / "config.json")
    params = params_from_numpy(tree, "cpu")
    tcache = KVCache.create(cfg, 1, MAX_SEQ, dtype=torch.float32, device="cpu")
    got, tcache = forward(params, tcache, torch.from_numpy(prompt).long(), 0, cfg)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=1e-4)
    for i, t in enumerate(steps):
        got, tcache = forward(params, tcache, torch.tensor([[int(t)]]), 64 + i, cfg)
        np.testing.assert_allclose(got.numpy(), want[i + 1], rtol=0, atol=1e-4)


def test_w4a8_int8kv_greedy_tokens_identical(jax_fixture):
    """W4A8 + int8 KV (the main path's scheme): 3 prompts of 48 tokens, 24
    greedy tokens each, identical tokens; prefill top-1 identical at every
    prompt position."""
    jcfg, jparams, tokens = jax_fixture
    jq = jfuse(jquantize_params(jparams, bits=4, group_size=None, act_bits=8), jcfg)
    prompts = tokens[:3 * 48].reshape(3, 48)
    pre_logits, _ = jforward(jq, JQKVCache.create(jcfg, 3, MAX_SEQ), jnp.asarray(prompts),
                             0, jcfg)
    want_top1 = np.asarray(jnp.argmax(pre_logits, axis=-1))
    want_tokens = np.asarray(jgenerate(jq, jcfg, jnp.asarray(prompts), max_new_tokens=24,
                                       quantized_kv=True))
    tree = jax_tree_to_numpy(jq)

    cfg = load_config(FIXTURE / "config.json")
    params = params_from_numpy(tree, "cpu")
    assert params["layers"]["wqkv"].q.shape == (cfg.num_layers, 768, 192)
    tp = torch.from_numpy(prompts).long()
    logits, _ = forward(params, QuantizedKVCache.create(cfg, 3, MAX_SEQ, device="cpu"),
                        tp, 0, cfg)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want_top1)
    got = generate(params, cfg, tp, max_new_tokens=24, quantized_kv=True)
    np.testing.assert_array_equal(got.numpy(), want_tokens)
