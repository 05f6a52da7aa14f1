"""The port's continuous-batching engine (metalchat_tpu_torch/engine/serving.py)
against the JAX package's, on the CPU.

The trained fixture (tests/fixtures/pyllama_10m) quantized W4A8 with int8
KV at f32 activations, parameters crossed as numpy bytes. The same five
greedy requests run through both engines with 3 slots, prompt chunks of 32,
decode bursts of 4 and a prefill interleave of 1, so that batched prefill,
combined prefill + burst dispatches and ride-along rows all occur. Tokens,
finish reasons and dispatch counters must be identical, in dense int8 mode,
dense mode in the activation dtype and paged mode. Pages of 8 also send a short last chunk (16 tokens)
through the layer-by-layer route (a paged cache takes windows of 2-16
tokens there, as in the JAX package), and a 15-token prompt ends one token
short of a page edge.

The prompts are fixed slices of the fixture's evaluation tokens. With W4A8
a ulp of difference before an activation's int8 rounding can move one code
and, many tokens later, a near-tied greedy choice; these slices have no
such tie in their first 16 tokens.

On the CPU the decode step runs eagerly on the engine's fixed buffers. The
card's route (one warm-up step, then one captured step per sampling branch,
replayed) runs here with a stand-in graph whose capture records the step and
whose replay runs it (`ExecutingGraph`).
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
from metalchat_tpu_torch.engine import serving
from metalchat_tpu_torch.ops._build import CountedGraph
from metalchat_tpu_torch.sampling import SamplerConfig
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


def _run(fixture, mode, prompts=None, samplers=None, engine_class=ContinuousBatchingEngine,
         **kw):
    cfg, params, default_prompts, _ = fixture
    prompts = prompts or default_prompts
    samplers = samplers or [SamplerConfig.greedy()] * len(prompts)
    engine = engine_class(params, cfg, **{**COMMON, **MODES[mode], **kw})
    out = engine.run([Request(prompt=p, max_new_tokens=NEW, sampler=c)
                      for p, c in zip(prompts, samplers)])
    return engine, list(out.values())


class _Recorder:
    """The stand-in's graph: holds the recorded step and the generators
    registered with it; a replay runs the step."""

    def __init__(self, events):
        self.events, self.fn, self.generators = events, None, []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.events.append(("replay", id(self)))
        self.fn()


class ExecutingGraph(CountedGraph):
    """A CountedGraph stand-in on the CPU: `capture` records the step and
    runs nothing, as a capture on the card runs nothing; `replay` runs it."""

    events: list = []

    def __init__(self, **options):
        super().__init__(graph=_Recorder(self.events), context=None, **options)

    def capture(self, fn):
        self.events.append(("capture", id(self.graph)))
        self.graph.fn = fn


class StandInEngine(ContinuousBatchingEngine):
    """The engine on the card's route, with `ExecutingGraph` for graphs."""

    def _graph_route(self) -> bool:
        return True


@pytest.fixture
def stand_in(monkeypatch):
    events = []
    monkeypatch.setattr(ExecutingGraph, "events", events)
    monkeypatch.setattr(serving, "CountedGraph", ExecutingGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool", 0))
    return events


# Per request (LENGTHS): greedy, top-k + top-p, greedy, temperature only,
# top-k + top-p; so bursts take every sampling branch.
MIXED = [SamplerConfig.greedy(), SamplerConfig(temperature=0.8, top_k=20, top_p=0.9),
         SamplerConfig.greedy(), SamplerConfig(temperature=0.8, top_k=0, top_p=1.0),
         SamplerConfig(temperature=0.8, top_k=20, top_p=0.9)]


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


def _check_captures(engine, events, branches):
    """Each branch captured once, before any replay of its graph, then only
    replayed; every step but one warm-up step a branch is a replay; every
    graph shares the engine's pool and registers its generator."""
    graphs = engine._graphs
    assert set(graphs) == set(branches)
    for graph in graphs.values():
        mine = [kind for kind, g in events if g == id(graph.graph)]
        assert mine[0] == "capture" and mine.count("capture") == 1
        assert graph.graph.generators == [engine._gen]
        assert graph._options == {"pool": ("pool", 0)}
    replays = sum(kind == "replay" for kind, _ in events)
    assert replays == engine.counters["decode_steps"] - len(graphs)


@pytest.mark.parametrize("mode", ["dense", "paged16"])
def test_engine_graph_route_matches_jax(fixture, stand_in, mode):
    """The card's route with executing stand-in graphs: the JAX engine's
    ids, finish reasons and counters, and the eager engine's prompt-chunk
    shapes."""
    engine, out = _run(fixture, mode, engine_class=StandInEngine)
    want_tokens, want_reasons, want_counters = fixture[3][mode]
    assert [c.tokens for c in out] == want_tokens
    assert [c.finish_reason for c in out] == want_reasons
    assert engine.counters == want_counters
    eager, _ = _run(fixture, mode)
    assert engine.prefill_shapes == eager.prefill_shapes
    _check_captures(engine, stand_in, ["greedy"])
    if engine.paged:
        assert engine.allocator.free_pages == engine.num_pages


def test_engine_mixed_samplers(fixture, stand_in):
    """Greedy rows beside drawing rows: the greedy rows equal an all-greedy
    run's, a run is reproducible under one seed and changes with another,
    and the card's route (stand-in graphs, one capture per branch) draws the
    same ids as the eager step."""
    def ids(**kw):
        return [c.tokens for c in _run(fixture, "paged16", samplers=MIXED, **kw)[1]]

    mixed = ids()
    greedy = fixture[3]["paged16"][0]  # the all-greedy run (the port's equals it)
    for i, cfg in enumerate(MIXED):
        assert (mixed[i] == greedy[i]) == cfg.is_greedy
    assert ids() == mixed
    other = ids(seed=1)
    assert other != mixed
    assert all(other[i] == mixed[i] for i, cfg in enumerate(MIXED) if cfg.is_greedy)
    engine, out = _run(fixture, "paged16", samplers=MIXED, engine_class=StandInEngine)
    assert [c.tokens for c in out] == mixed
    _check_captures(engine, stand_in, ["greedy", "draw", "truncate"])
