"""The port's generation layer (metalchat_tpu_torch/engine/generate.py, the
penalties of sampling.py, cache.roll_kv_cache, the launch accounting of
ops/_build.py) against the JAX package, on the CPU.

Inputs are made with numpy from a seed, or are the JAX package's own random
or trained parameters, and cross as numpy (`convert.params_from_numpy`).
Tolerances: token ids, final positions and rolled caches are held exactly;
`apply_penalties` within 1e-6 relative in f32 (the same arithmetic, one
scatter-add order). Activations are f32: the JAX CPU backend has no bf16
dot, so the fixture's dense case is dense f32 weights and cache. On the CPU
the decode step runs eagerly; the CUDA graph it becomes on the card is held
against the eager loop in `test_torch_cuda.py` and `chip_smoke.py`.
"""

import contextlib
import gc
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metalchat_tpu import sampling as jsampling
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.cache import roll_kv_cache as jroll
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine import generate_stream as jgenerate_stream
from metalchat_tpu.engine import make_decode_step as jmake_decode_step
from metalchat_tpu.engine import make_prefill as jmake_prefill
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models import init_random_params as jinit_random_params
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch import sampling
from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache, roll_kv_cache
from metalchat_tpu_torch.config import LlamaConfig, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import (
    DecodeState,
    generate,
    generate_stream,
    make_decode_step,
    make_prefill,
)
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.ops import _build
from test_model import TINY_LLAMA
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
MAX_SEQ = 128
GREEDY = sampling.SamplerConfig.greedy()
JGREEDY = jsampling.SamplerConfig.greedy()
TINY = LlamaConfig(**{f.name: getattr(TINY_LLAMA, f.name)
                      for f in dataclasses.fields(LlamaConfig)})
# With tied embeddings a random tiny Llama mostly repeats the prompt's last
# token. TINY_SEED is the first seed from 11 (tests/test_generate.py
# searches the same way) whose rollout of TINY_PROMPTS[0] is not one token
# repeated, so an EOS id has a first position after 0.
TINY_SEED, TINY_PROMPTS = 24, [[5, 9, 23, 42], [9, 8, 7, 1]]


@pytest.fixture(scope="module")
def fixture():
    """The trained fixture in f32: JAX config, JAX params by scheme, port
    config, eval tokens."""
    jcfg = jload_config(FIXTURE / "config.json")
    dense = jload_params(jopen(FIXTURE), jcfg, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    w4a8 = jfuse(jquantize_params(dense, bits=4, group_size=None, act_bits=8), jcfg)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    return jcfg, {"dense": dense, "w4a8": w4a8}, load_config(FIXTURE / "config.json"), tokens


def port(jparams):
    return params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def tiny_rollout(prompts):
    """TINY_LLAMA's JAX params at TINY_SEED and their greedy rollouts of
    ``prompts`` (8 tokens, through the JAX package's generate)."""
    params = jinit_random_params(TINY_LLAMA, seed=TINY_SEED, dtype=jnp.float32)
    cache = JKVCache.create(TINY_LLAMA, len(prompts), 32, dtype=jnp.float32)
    out = np.asarray(jgenerate(params, TINY_LLAMA, jnp.asarray(prompts, jnp.int32),
                               max_new_tokens=8, cache=cache))
    return params, out


def first_new(row):
    """The first position after 0 whose token is new in the rollout."""
    return next(i for i in range(1, len(row)) if row[i] not in row[:i])


# -- generate --------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["w4a8-int8kv", "dense-f32"])
def test_generate_fixture_greedy_identical(fixture, scheme):
    """3 prompts of 48 tokens, 24 greedy tokens each: identical ids. The
    prompts are ``eval_tokens[1440:1584]``, whose greedy rollouts have no
    near tie (ROADMAP.md, Known behaviours: on some slices the two packages
    part at a tie)."""
    jcfg, jparams, cfg, tokens = fixture
    quantized = scheme == "w4a8-int8kv"
    jp = jparams["w4a8" if quantized else "dense"]
    prompts = tokens[1440:1584].reshape(3, 48)
    jcache = (JQKVCache.create(jcfg, 3, MAX_SEQ) if quantized
              else JKVCache.create(jcfg, 3, MAX_SEQ, dtype=jnp.float32))
    want = np.asarray(jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=24,
                                cache=jcache))
    got = generate(port(jp), cfg, torch.from_numpy(prompts).long(), max_new_tokens=24,
                   quantized_kv=quantized, max_seq_len=MAX_SEQ)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_tiny_batched_rows_and_eos():
    """A tiny random Llama, two rows at once: identical to JAX, each row as
    it is alone; with an EOS id from row 0's rollout, row 0 freezes on it
    from its first appearance and row 1 runs on, identical to JAX."""
    jp, want = tiny_rollout(TINY_PROMPTS)
    tp = port(jp)
    both = generate(tp, TINY, torch.tensor(TINY_PROMPTS), max_new_tokens=8, max_seq_len=32)
    np.testing.assert_array_equal(both.numpy(), want)
    for i, p in enumerate(TINY_PROMPTS):
        solo = generate(tp, TINY, torch.tensor([p]), max_new_tokens=8, max_seq_len=32)
        np.testing.assert_array_equal(solo.numpy()[0], want[i])

    row = want[0].tolist()
    j = first_new(row)
    eos = (row[j],)
    jcache = JKVCache.create(TINY_LLAMA, 2, 32, dtype=jnp.float32)
    want_eos = np.asarray(jgenerate(jp, TINY_LLAMA, jnp.asarray(TINY_PROMPTS, jnp.int32),
                                    max_new_tokens=8, cache=jcache, eos_ids=eos))
    got = generate(tp, TINY, torch.tensor(TINY_PROMPTS), max_new_tokens=8, max_seq_len=32,
                   eos_ids=eos).numpy()
    np.testing.assert_array_equal(got, want_eos)
    assert (got[0, j:] == eos[0]).all() and (got[0, :j] != eos[0]).all()


def test_prefill_and_decode_steps_identical(fixture):
    """make_prefill, then 10 × make_decode_step on the W4A8 fixture with an
    int8 cache and an EOS id that stops row 1 part-way: every step's
    emitted ids, the carried ids, done and the final pos equal JAX's."""
    jcfg, jparams, cfg, tokens = fixture
    prompts = tokens[:3 * 40].reshape(3, 40)
    jp = jparams["w4a8"]
    ref = np.asarray(jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=11,
                               quantized_kv=True, max_seq_len=MAX_SEQ))
    eos = (ref[1, first_new(ref[1].tolist())],)

    jprefill = jmake_prefill(jcfg, JGREEDY, eos)
    jstep = jmake_decode_step(jcfg, JGREEDY, eos)
    jstate = jprefill(jp, JQKVCache.create(jcfg, 3, MAX_SEQ), jnp.asarray(prompts), 0,
                      jax.random.PRNGKey(0))
    want = []
    for _ in range(10):
        jstate, emitted = jstep(jp, jstate)
        want.append(np.asarray(emitted))

    tp = port(jp)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = make_prefill(cfg, GREEDY, eos)(
        tp, QuantizedKVCache.create(cfg, 3, MAX_SEQ, device="cpu"),
        torch.from_numpy(prompts).long(), 0, gen)
    assert isinstance(state, DecodeState) and int(state.pos) == 40
    step = make_decode_step(cfg, GREEDY, eos)
    got = []
    for _ in range(10):
        state, emitted = step(tp, state)
        got.append(emitted.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(state.last_tokens.numpy(), np.asarray(jstate.last_tokens))
    np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
    assert bool(state.done[1]) and state.pos.dtype == torch.int32
    assert int(state.pos) == int(jstate.pos) == 50
    assert step._graphs == {}  # no graph on the CPU


@pytest.mark.parametrize("start", ["int", "0-d", "per-row"])
def test_decode_step_position_as_tensor(fixture, start):
    """A decode step at a 0-d or ``[B]`` position tensor gives the logits of
    the same step at an int position, bit for bit, and leaves the same
    cache."""
    _, jparams, cfg, tokens = fixture
    tp = port(jparams["w4a8"])
    prompts = torch.from_numpy(tokens[:2 * 20].reshape(2, 20)).long()
    nxt = torch.from_numpy(tokens[40:42]).long()[:, None]
    caches = []
    for pos in (20, {"int": 20, "0-d": torch.tensor(20, dtype=torch.int32),
                     "per-row": torch.tensor([20, 20], dtype=torch.int32)}[start]):
        cache = QuantizedKVCache.create(cfg, 2, 32, device="cpu")
        forward(tp, cache, prompts, 0, cfg)
        logits, cache = forward(tp, cache, nxt, pos, cfg)
        caches.append((logits, cache))
    (want, c0), (got, c1) = caches
    assert torch.equal(got, want)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(c1, name), getattr(c0, name))


# -- generate_stream -------------------------------------------------------------

def test_stream_with_sinks_past_the_cache(fixture):
    """The dense f32 fixture in a 40-position cache, a 24-token prompt and
    48 tokens with 4 sink positions: the cache rolls (9 positions at a time)
    four times; the ids equal JAX's generate_stream."""
    jcfg, jparams, cfg, tokens = fixture
    prompt = tokens[200:224].tolist()
    want = list(jgenerate_stream(jparams["dense"], jcfg, prompt, max_new_tokens=48,
                                 sampler=JGREEDY, sink_tokens=4,
                                 cache=JKVCache.create(jcfg, 1, 40, dtype=jnp.float32)))
    cache = KVCache.create(cfg, 1, 40, dtype=torch.float32, device="cpu")
    got = list(generate_stream(port(jparams["dense"]), cfg, prompt, max_new_tokens=48,
                               sampler=GREEDY, sink_tokens=4, cache=cache))
    assert len(got) == 48 and len(set(got)) > 4
    assert got == want


def test_stream_stops_at_window_and_on_eos():
    """Without sinks the stream stops at the cache's end; with an EOS id it
    stops right after emitting it; each as JAX's does."""
    prompt = TINY_PROMPTS[0]
    jp, want = tiny_rollout([prompt])
    tp = port(jp)
    eos = (int(want[0, first_new(want[0].tolist())]),)
    for limit, kw in ((12, {}), (32, {"eos_ids": eos})):
        jcache = JKVCache.create(TINY_LLAMA, 1, limit, dtype=jnp.float32)
        ref = list(jgenerate_stream(jp, TINY_LLAMA, prompt, max_new_tokens=20,
                                    sampler=JGREEDY, cache=jcache, **kw))
        cache = KVCache.create(TINY, 1, limit, dtype=torch.float32, device="cpu")
        got = list(generate_stream(tp, TINY, prompt, max_new_tokens=20, sampler=GREEDY,
                                   cache=cache, **kw))
        assert got == ref and len(got) < 20


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_roll_kv_cache_exact_in_place(kind):
    """Random caches rolled (2 sinks, shift 5, 16 positions): every tensor
    equals JAX's roll and keeps its storage."""
    rng = np.random.default_rng(3)
    shape = (3, 2, 2, 16, 8)
    if kind == "dense":
        arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        jcache = JKVCache(*(jnp.asarray(a) for a in arrays))
        cache = KVCache(*(torch.from_numpy(a.copy()) for a in arrays))
    else:
        arrays = [rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2)]
        arrays += [rng.random(shape[:-1], dtype=np.float32) for _ in range(2)]
        jcache = JQKVCache(*(jnp.asarray(a) for a in arrays))
        cache = QuantizedKVCache(*(torch.from_numpy(a.copy()) for a in arrays))
    names = [f.name for f in dataclasses.fields(cache)]
    ptrs = [getattr(cache, n).data_ptr() for n in names]
    want = jroll(jcache, num_sink=2, shift=5)
    assert roll_kv_cache(cache, 2, 5) is cache
    for n, p in zip(names, ptrs):
        assert getattr(cache, n).data_ptr() == p
        np.testing.assert_array_equal(getattr(cache, n).numpy(), np.asarray(getattr(want, n)))


# -- sampling penalties ----------------------------------------------------------

PENALTIES = [dict(repetition_penalty=1.3), dict(frequency_penalty=0.25),
             dict(presence_penalty=0.7),
             dict(repetition_penalty=2.0, frequency_penalty=0.1, presence_penalty=0.5)]


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "history-mask"])
@pytest.mark.parametrize("penalty", PENALTIES, ids=lambda p: "-".join(p))
def test_apply_penalties_matches_jax(penalty, masked):
    """Random logits [4, 97] and histories of 12 ids with repeats (padding
    masked out in the second case): within 1e-6 relative of JAX in f32."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 97)) * 3).astype(np.float32)
    history = rng.integers(0, 20, (4, 12)).astype(np.int32)
    mask = (rng.random((4, 12)) < 0.7).astype(np.float32) if masked else None
    want = np.asarray(jsampling.apply_penalties(
        jnp.asarray(logits), jnp.asarray(history), jsampling.SamplerConfig(**penalty),
        None if mask is None else jnp.asarray(mask)))
    got = sampling.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(history),
        sampling.SamplerConfig(**penalty), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and sampling.SamplerConfig(**penalty).penalizes
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_penalties_shift_and_steer_greedy():
    """tests/test_sampling.py's cases through the port: the shifted values,
    padding left out by the mask, a presence penalty that moves the greedy
    pick; and greedy ids with history equal JAX's on random rows."""
    logits = torch.zeros((1, 8))
    logits[0, 2], logits[0, 3] = 1.0, -1.0
    cfg = sampling.SamplerConfig(repetition_penalty=2.0, frequency_penalty=0.1,
                                 presence_penalty=0.5)
    out = sampling.apply_penalties(logits, torch.tensor([[2, 2, 3, 7]]), cfg)
    np.testing.assert_allclose(out[0, [2, 3, 1]].numpy(), [-0.2, -2.6, 0.0], atol=1e-6)
    out = sampling.apply_penalties(torch.zeros((1, 8)), torch.tensor([[5, 0, 0, 0]]),
                                   sampling.SamplerConfig(presence_penalty=1.0),
                                   torch.tensor([[1.0, 0, 0, 0]]))
    assert out[0, 5] == -1.0 and out[0, 0] == 0.0
    steer = torch.zeros((1, 8))
    steer[0, 4], steer[0, 1] = 3.0, 2.0
    greedy = sampling.SamplerConfig(temperature=0.0, presence_penalty=10.0)
    assert int(sampling.sample(steer, None, greedy, history=torch.tensor([[4]]))[0]) == 1
    assert not sampling.SamplerConfig().penalizes

    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((6, 97)) * 2).astype(np.float32)
    history = np.stack([np.argsort(-row)[:5] for row in logits]).astype(np.int32)
    for kw in PENALTIES:
        jcfg = jsampling.SamplerConfig(temperature=0.0, **kw)
        want = np.asarray(jsampling.sample(jnp.asarray(logits), None, jcfg,
                                           history=jnp.asarray(history)))
        got = sampling.sample(torch.from_numpy(logits), None,
                              sampling.SamplerConfig(temperature=0.0, **kw),
                              history=torch.from_numpy(history))
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, logits.argmax(-1))  # the last config moved picks


def test_stochastic_draw_is_multinomials():
    """`sample`'s draw (argmax of p / q, q ~ Exp(1)) gives torch.multinomial's
    ids from the same generator state, without its host-side checks."""
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 97)) * 3)
    cfg = sampling.SamplerConfig()
    for seed in range(8):
        gen = torch.Generator()
        gen.manual_seed(seed)
        got = sampling.sample(logits, gen, cfg)
        gen.manual_seed(seed)
        masked = sampling.top_p_mask(sampling.top_k_mask(logits.float() / 0.6, 50), 0.9)
        want = torch.multinomial(torch.softmax(masked, -1), 1, generator=gen)[:, 0]
        assert torch.equal(got, want)


# -- launch accounting under capture and replay ----------------------------------

class StandInGraph:
    """Runs nothing: a capture records, a replay counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_counts_under_capture_and_replay():
    """Launches made while a CountedGraph captures are the graph's and
    count 0; each replay adds them once; outside a capture they count as
    before; a second capture inside the first raises, and a failed capture
    leaves counting as it was."""
    _build.reset_launch_counts()
    graph = _build.CountedGraph(StandInGraph(), lambda g: contextlib.nullcontext())

    def step():
        for _ in range(3):
            _build.count_launch("a8_matvec")
            _build.count_launch("a8_quantize")
        _build.count_launch("decode_attention_update")
        return "out"

    assert graph.capture(step) == "out"
    assert all(n == 0 for n in _build.LAUNCHES.values())
    assert graph.launches == {"a8_matvec": 3, "a8_quantize": 3, "decode_attention_update": 1}
    for _ in range(4):
        graph.replay()
    assert graph.graph.replays == 4
    assert _build.LAUNCHES["a8_matvec"] == 12 and _build.LAUNCHES["decode_attention_update"] == 4
    _build.count_launch("flash_attention")
    assert _build.LAUNCHES["flash_attention"] == 1

    other = _build.CountedGraph(StandInGraph(), lambda g: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="already under way"):
        graph.capture(lambda: other.capture(step))
    _build.count_launch("flash_attention")
    assert _build.LAUNCHES["flash_attention"] == 2 and other.launches == {}
    _build.reset_launch_counts()


def test_capture_holds_the_cyclic_collector():
    """The cyclic garbage collector is off while a CountedGraph captures (a
    graph it destroyed mid-capture would invalidate the capture on the card)
    and back on afterwards, also after a failed capture; a collector the
    caller had turned off stays off."""
    graph = _build.CountedGraph(StandInGraph(), lambda g: contextlib.nullcontext())
    assert gc.isenabled()
    assert graph.capture(gc.isenabled) is False
    assert gc.isenabled()

    def fails():
        raise ValueError("capture fails")

    with pytest.raises(ValueError, match="capture fails"):
        graph.capture(fails)
    assert gc.isenabled()
    gc.disable()
    try:
        graph.capture(gc.isenabled)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_smoke_first_layers_is_a_shallower_model_of_views():
    """`chip_smoke.first_layers` (the serve phases' depth cut): the depth is
    replaced, each stacked leaf is a view of the full tree's first layers,
    and `generate` on the cut tree equals `generate` on those layers copied
    into a model of that depth (W4A8 and a LoRA leaf)."""
    import chip_smoke
    from metalchat_tpu_torch.quant.quantize import (LoraLinear, QuantizedTensor,
                                                    init_random_quantized_params)

    cfg = TINY.replace(num_layers=4)
    params = init_random_quantized_params(cfg, bits=4, group_size=None, act_bits=8,
                                          seed=3, max_seq_len=32, dtype=torch.float32,
                                          device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    wo = params["layers"]["wo"]
    params["layers"]["wo"] = LoraLinear(
        base=wo, a=0.02 * torch.randn((4, cfg.hidden_size, 4), generator=gen),
        b=0.02 * torch.randn((4, 4, cfg.hidden_size), generator=gen))
    ccfg, cut = chip_smoke.first_layers((cfg, params), 2, "test")
    assert ccfg.num_layers == 2 and cfg.num_layers == 4
    for name, leaf in cut["layers"].items():
        full = params["layers"][name]
        if isinstance(leaf, LoraLinear):
            assert leaf.a.data_ptr() == full.a.data_ptr() and leaf.b.shape[0] == 2
            leaf, full = leaf.base, full.base
        if isinstance(leaf, QuantizedTensor):
            assert leaf.q.shape[0] == 2 and leaf.q.data_ptr() == full.q.data_ptr()
            assert leaf.scales.data_ptr() == full.scales.data_ptr()
        else:
            assert leaf.shape[0] == 2 and leaf.data_ptr() == full.data_ptr()
    assert all(cut[k] is params[k] for k in params if k != "layers")
    def copy2(leaf):  # the first two layers, copied into tensors of their own
        if isinstance(leaf, QuantizedTensor):
            return dataclasses.replace(leaf, q=leaf.q[:2].clone(), scales=leaf.scales[:2].clone())
        if isinstance(leaf, LoraLinear):
            return dataclasses.replace(leaf, base=copy2(leaf.base), a=leaf.a[:2].clone(),
                                       b=leaf.b[:2].clone())
        return leaf[:2].clone()

    copied = {**params, "layers": {k: copy2(v) for k, v in params["layers"].items()}}
    prompts = torch.tensor(TINY_PROMPTS)
    got = generate(cut, ccfg, prompts, max_new_tokens=8, max_seq_len=32)
    want = generate(copied, ccfg, prompts, max_new_tokens=8, max_seq_len=32)
    assert torch.equal(got, want)
    full = generate(params, cfg, prompts, max_new_tokens=8, max_seq_len=32)
    assert not torch.equal(got, full)  # the cut reaches the model
