"""The port's continuous-batching engine (metalchat_tpu_torch/engine/serving.py)
against the JAX package's, on the CPU.

The trained fixture (tests/fixtures/pyllama_10m) quantized W4A8 with int8
KV at f32 activations, parameters crossed as numpy bytes. The same five
greedy requests run through both engines with 3 slots, prompt chunks of 32,
decode bursts of 4 and a prefill interleave of 1, so that batched prefill,
combined prefill + burst dispatches and ride-along rows all occur. Tokens,
finish reasons and dispatch counters must be identical, in dense int8 mode,
dense mode in the activation dtype and paged mode. Pages of 8 also send a short last chunk (16 tokens)
through the decode-window path, and a 15-token prompt ends one token short
of a page edge.

The prompts are fixed slices of the fixture's evaluation tokens. With W4A8
a ulp of difference before an activation's int8 rounding can move one code
and, many tokens later, a near-tied greedy choice; these slices have no
such tie in their first 16 tokens.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from metalchat_tpu.engine.serving import Request as JRequest
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
MAX_SEQ = 128
LENGTHS = (5, 70, 35, 15, 48)
NEW = 16
COMMON = dict(max_slots=3, max_seq_len=MAX_SEQ, prefill_chunk=32, decode_burst=4,
              prefill_interleave=1)
MODES = {"dense": dict(quantized_kv=True),
         "dense-act": dict(),
         "paged16": dict(cache_mode="paged", page_size=16),
         "paged8": dict(cache_mode="paged", page_size=8)}


@pytest.fixture(scope="module")
def fixture():
    jcfg = jload_config(FIXTURE / "config.json")
    jparams = jload_params(jopen(FIXTURE), jcfg, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jq = jfuse(jquantize_params(jparams, bits=4, group_size=None, act_bits=8), jcfg)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int64)
    prompts = [tokens[1000 + 100 * i:1000 + 100 * i + n].tolist()
               for i, n in enumerate(LENGTHS)]
    jax_runs = {}
    for mode, kw in MODES.items():
        engine = JEngine(jq, jcfg, **COMMON, **kw)
        out = engine.run([JRequest(prompt=p, max_new_tokens=NEW) for p in prompts])
        jax_runs[mode] = ([c.tokens for c in out.values()],
                          [c.finish_reason for c in out.values()], dict(engine.counters))
    cfg = load_config(FIXTURE / "config.json")
    params = params_from_numpy(jax_tree_to_numpy(jq), "cpu")
    return cfg, params, prompts, jax_runs


def _run(fixture, mode, prompts=None, **kw):
    cfg, params, default_prompts, _ = fixture
    engine = ContinuousBatchingEngine(params, cfg, **{**COMMON, **MODES[mode], **kw})
    out = engine.run([Request(prompt=p, max_new_tokens=NEW)
                      for p in (prompts or default_prompts)])
    return engine, list(out.values())


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(fixture, mode):
    engine, out = _run(fixture, mode)
    want_tokens, want_reasons, want_counters = fixture[3][mode]
    assert [c.tokens for c in out] == want_tokens
    assert [c.finish_reason for c in out] == want_reasons == ["length"] * len(LENGTHS)
    assert engine.counters == want_counters
    assert engine.counters["combined_dispatches"] > 0
    assert sum(engine.prefill_shapes.values()) == (engine.counters["prefill_dispatches"]
                                                   + engine.counters["combined_dispatches"])
    if engine.paged:
        assert engine.allocator.free_pages == engine.num_pages


def test_paged_equals_dense_at_the_pool_end(fixture):
    """A prompt whose pages and decode fill the whole pool but its last
    position: padded writes stay inside the row's pages."""
    prompt = [fixture[2][1][:47]]
    _, dense = _run(fixture, "dense", prompt, max_seq_len=64)
    engine, paged = _run(fixture, "paged16", prompt, max_seq_len=64, num_pages=4)
    assert paged[0].tokens == dense[0].tokens and len(paged[0].tokens) == NEW
    assert engine.allocator.free_pages == 4


def test_kv_oom_contained(fixture):
    """A request that outgrows the page pool finishes with kv_oom; a small
    one completes afterwards (containment + page recycling)."""
    cfg, params, *_ = fixture
    engine = ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=64,
                                      cache_mode="paged", page_size=4, num_pages=4)
    big = Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=30)   # needs 9 pages
    small = Request(prompt=[7, 8], max_new_tokens=3)
    out = engine.run([big, small])
    assert out[big.request_id].finish_reason == "kv_oom"
    assert out[small.request_id].finish_reason == "length"
    assert len(out[small.request_id].tokens) == 3
    assert engine.allocator.free_pages == 4


def test_unsatisfiable_prompt_rejected(fixture):
    """A prompt larger than the whole pool can never run → kv_oom, no hang."""
    cfg, params, *_ = fixture
    engine = ContinuousBatchingEngine(params, cfg, max_slots=1, max_seq_len=64,
                                      cache_mode="paged", page_size=4, num_pages=2)
    req = Request(prompt=list(range(1, 30)), max_new_tokens=4)
    out = engine.run([req])
    assert out[req.request_id].finish_reason == "kv_oom"
    assert "pages" in out[req.request_id].error


def test_submit_validation_and_cancel(fixture):
    cfg, params, prompts, _ = fixture
    engine = ContinuousBatchingEngine(params, cfg, max_slots=1, max_seq_len=MAX_SEQ,
                                      cache_mode="paged", page_size=16)
    empty = engine.submit(Request(prompt=[]))
    too_long = engine.submit(Request(prompt=[1] * 100, max_new_tokens=40))
    running = engine.submit(Request(prompt=prompts[0], max_new_tokens=NEW))
    queued = engine.submit(Request(prompt=prompts[1], max_new_tokens=NEW))
    assert engine.completion(empty).finish_reason == "error"
    assert "max_seq_len" in engine.completion(too_long).error
    while len(engine.completion(running).tokens) < 2:
        engine.step()
    assert engine.cancel(queued) and engine.cancel(running)
    assert not engine.cancel(running)  # already finished
    assert not engine.has_work and engine.allocator.free_pages == engine.num_pages
    assert engine.completion(running).finish_reason == "cancelled"
    metrics = engine.metrics()
    assert metrics["requests"] == 1.0 and metrics["prefill_dispatches"] >= 1
