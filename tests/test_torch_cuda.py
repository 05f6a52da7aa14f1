"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the decode step captured in a CUDA graph against the eager loop.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device. Run on a machine with an H100 from the repository root:
``python -m pytest -m cuda tests/test_torch_cuda.py -q``. The same checks run
at the main path's full shapes in ``chip_smoke.py``; these use the
fixture's small shapes (hd=64) and Gemma-3's head size (hd=256) at small
widths, in bf16 and in f32 activations. The graph
route is held to the eager loop bit for bit: the same kernels in the same
order, fixed merge orders.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda
DTYPES = pytest.mark.parametrize("dtype", ["bfloat16", "float32"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sm = chip_smoke.Smoke(torch)
    yield sm, gen, torch.device("cuda")
    sm.counters_at_rest("after the test")


@DTYPES
def test_a8_matvec_kernel(card, dtype):
    sm, gen, dev = card
    dt = getattr(torch, dtype)
    chip_smoke.check_a8(sm, [("wqkv", 768, 384, 4, True), ("w2", 384, 1024, 8, False)],
                        1, gen, dev, dt)
    chip_smoke.check_a8(sm, [("w13", 2048, 384, 4, True)], 7, gen, dev, dt)
    # One row at edge widths: a ragged last step, out not a multiple of the tile.
    chip_smoke.check_a8(sm, chip_smoke.A8_EDGE, 1, gen, dev, dt)


# 2-16 rows: a8_quantize and the int8 tensor-core matvec, one n-tile (2, 8)
# and two (16): raw mode exact, fused within the limit of the plain version.
@DTYPES
@pytest.mark.parametrize("rows", [2, 8, 16])
def test_a8_matvec_mma_route(card, dtype, rows):
    sm, gen, dev = card
    chip_smoke.check_a8(sm, chip_smoke.A8_FIXTURE, rows, gen, dev, getattr(torch, dtype))


@DTYPES
def test_decode_attention_update_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_decode(sm, 3, 6, 3, 256, 64, chip_smoke.DECODE_CASES_FIXTURE, gen, dev,
                            getattr(torch, dtype))


@DTYPES
@pytest.mark.parametrize("kv", ["act", "int8"])
def test_decode_attention_read_kernel(card, dtype, kv):
    sm, gen, dev = card
    chip_smoke.check_decode_read(sm, 3, 6, 3, 256, 64, chip_smoke.READ_CASES_FIXTURE, gen,
                                 dev, getattr(torch, dtype), kv)


@DTYPES
def test_flash_attention_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_flash(sm, 3, 48, 6, 3, 256, 64, chip_smoke.FLASH_CASES_FIXTURE, gen, dev,
                           getattr(torch, dtype))


# The redesigned kernels at their new edges, at the 8B shapes: decode lengths
# around the chunk of SPLIT_CHUNK positions, windows starting inside a chunk,
# a serve batch that leaves most chunks dead; flash over a ragged S from
# unaligned starts.
def test_decode_attention_chunk_edges_8b(card):
    sm, gen, dev = card
    chip_smoke.check_decode(sm, 1, 32, 8, 1024, 128, chip_smoke.DECODE_CASES_8B, gen, dev)
    chip_smoke.check_decode(sm, 8, 32, 8, 1024, 128, chip_smoke.DECODE_CASES_SERVE[-1:], gen,
                            dev)


@pytest.mark.parametrize("kv", ["act", "int8"])
def test_decode_attention_read_dead_chunks_8b(card, kv):
    sm, gen, dev = card
    lengths = chip_smoke.DECODE_CASES_SERVE[-1][0]
    chip_smoke.check_decode_read(sm, 8, 32, 8, 1024, 128,
                                 [(lengths, None), (lengths, chip_smoke.SPLIT_CHUNK + 3)], gen,
                                 dev, kv=kv)


def test_flash_attention_ragged_8b(card):
    sm, gen, dev = card
    chip_smoke.check_flash(sm, 1, chip_smoke.FLASH_RAGGED_S, 32, 8, 1024, 128,
                           chip_smoke.FLASH_CASES_RAGGED, gen, dev)


# Decode, flash and paged attention, the matvec and the dequant matmul
# (split-K and tensor-core routes) twice in one CUDA graph.
def test_attention_kernels_in_a_cuda_graph(card):
    sm, gen, dev = card
    chip_smoke.check_graph_replay(sm, 2, 32, 8, 1024, 128, gen, dev)
    chip_smoke.check_graph_replay(sm, 3, 6, 3, 256, 64, gen, dev)


# hd 256 (Gemma-3): rows 3, 4 and 8 at small shapes, windows that drop
# positions, the global layer's -1; bf16 and f32 (the f32 decode cache at hd
# 256 needs more than 48 KB of shared memory, and stages in two batches).
GEMMA_SMALL_DECODE = [([1], 8, "random"), ([40], 8, "random"), ([64], -1, "random"),
                      ([33], 24, "zeros")]
GEMMA_SMALL_FLASH = [(0, 8), (13, 24), (5, -1), ([0, 7], 8)]
GEMMA_SMALL_PAGED = [([40, 64, 9, 1], 20), ([64, 17, 33, 1], None)]


@DTYPES
def test_decode_attention_update_kernel_hd256(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_decode(sm, 1, 4, 1, 64, 256, GEMMA_SMALL_DECODE, gen, dev,
                            getattr(torch, dtype))


@DTYPES
def test_flash_attention_kernel_hd256(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_flash(sm, 2, 37, 4, 1, 64, 256, GEMMA_SMALL_FLASH, gen, dev,
                           getattr(torch, dtype))


@DTYPES
def test_paged_attention_kernel_hd256(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 4, 4, 1, 256, 16, 4, GEMMA_SMALL_PAGED, gen, dev,
                           getattr(torch, dtype))


@DTYPES
def test_paged_attention_kernel(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 4, 6, 3, 64, 16, 8, chip_smoke.PAGED_CASES_FIXTURE, gen, dev,
                           getattr(torch, dtype))


# The paged kernel's chunks of 32 positions across pages of 4 (fixture
# widths), 8 and 48 (8B widths), lengths at the chunk edges.
@DTYPES
def test_paged_attention_chunks_cross_pages(card, dtype):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 4, 6, 3, 64, 4, 32, chip_smoke.PAGED_CASES_P4, gen, dev,
                           getattr(torch, dtype))


def test_paged_attention_chunk_edges_8b(card):
    sm, gen, dev = card
    chip_smoke.check_paged(sm, 8, 32, 8, 128, 8, 16, chip_smoke.PAGED_CASES_P8, gen, dev)
    chip_smoke.check_paged(sm, 8, 32, 8, 128, 48, 4, chip_smoke.PAGED_CASES_P48, gen, dev)


@DTYPES
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_quant_matmul_kernel(card, dtype, rows):
    sm, gen, dev = card
    for scales in ("bfloat16", "float32"):
        chip_smoke.check_qmm(sm, chip_smoke.QMM_FIXTURE, rows, gen, dev, getattr(torch, dtype),
                             getattr(torch, scales))


@DTYPES
@pytest.mark.parametrize("rows", [1, 8, 32])
def test_quant_matmul_kernel_f32_output(card, dtype, rows):
    """Row 11's f32-output mode (a row-parallel partial, its sums not
    rounded to x's dtype) against its plain version, both storage
    orientations."""
    sm, gen, dev = card
    for scales in ("bfloat16", "float32"):
        chip_smoke.check_qmm(sm, chip_smoke.QMM_FIXTURE, rows, gen, dev, getattr(torch, dtype),
                             getattr(torch, scales), out_dtype=torch.float32)


def test_quant_matmul_tp_local_shapes(card):
    """Row 11 at phase tp-leaves' tp-2 local shapes (8b-int4 and qlora-1b),
    1 and 8 rows, and the row-parallel leaves in the f32-output mode."""
    sm, gen, dev = card
    for rows in (1, 8):
        chip_smoke.check_qmm(sm, chip_smoke.QMM_8B_INT4_TP2, rows, gen, dev)
        chip_smoke.check_qmm(sm, chip_smoke.QMM_QLORA_1B_TP2, rows, gen, dev,
                             scales_dtype=torch.float32)
        chip_smoke.check_qmm(sm, chip_smoke.QMM_ROW_PARALLEL_TP2, rows, gen, dev,
                             out_dtype=torch.float32)


@DTYPES
@pytest.mark.parametrize("rows", chip_smoke.FFN_ROWS)
def test_ffn_block_kernel(card, dtype, rows):
    sm, gen, dev = card
    chip_smoke.check_ffn_block(sm, 384, 1024, rows, chip_smoke.FFN_CASES, gen, dev,
                               getattr(torch, dtype))


# The first launch on a device makes the arrival counters. Its workspace must
# be held until the launch: a freed one was once handed to the counters, which
# then held partials and merged every later launch early. Freed NaN blocks
# make such a fault show.
def test_decode_first_launch_keeps_its_workspace(card):
    sm, gen, dev = card
    from metalchat_tpu_torch.ops import _build

    _build._RETIRED.extend(_build._COUNTERS.values())
    _build._COUNTERS.clear()
    torch.full((1 << 24,), float("nan"), device=dev)
    chip_smoke.check_decode(sm, 3, 6, 3, 112, 64, [([49, 64, 80], None, "random")], gen, dev)
    sm.counters_at_rest("decode, first launch")


# -- the decode step as a CUDA graph (engine/generate.py) ----------------------

def fixture_on_card(rows: int = 3):
    """The fixture (W4A8, bf16) on the card and ``rows`` prompts of 48
    tokens from chip_smoke's tie-free slice."""
    params, cfg, fixture = chip_smoke.fixture_params(torch, "cuda")
    tokens = np.load(fixture / "eval_tokens.npy")[chip_smoke.FIXTURE_INT_PROMPTS]
    prompts = torch.from_numpy(tokens[:48 * rows].astype(np.int64).reshape(rows, 48))
    return params, cfg, prompts.cuda()


def per_step(params, cfg, steps: int):
    """Launches of ``steps`` W4A8 decode steps over an int8 cache: four
    matvec calls a layer, and lm_head's where it is quantized."""
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    calls = (4 * cfg.num_layers + isinstance(params["lm_head"], QuantizedTensor)) * steps
    return dict(a8_matvec=calls, a8_quantize=calls,
                decode_attention_update=cfg.num_layers * steps)


def test_generate_graph_matches_eager_loop(card, monkeypatch):
    """generate on the fixture, 3 rows, 24 tokens (a warm-up step, the
    capture, 22 replays): the ids, the last step's logits and the cache
    equal the eager loop of `forward` calls bit for bit; launches exact."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    params, cfg, prompts = fixture_on_card()
    seen = {}  # the last logits of each shape, copied inside the graph too

    def recording(*args, **kwargs):
        logits, cache = real_forward(*args, **kwargs)
        seen.setdefault(tuple(logits.shape), torch.empty_like(logits)).copy_(logits)
        return logits, cache

    real_forward = gm.forward
    monkeypatch.setattr(gm, "forward", recording)
    reset_launch_counts()
    cache = QuantizedKVCache.create(cfg, 3, 128, device="cuda")
    got = generate(params, cfg, prompts, max_new_tokens=24, cache=cache)
    counts = launch_counts()
    monkeypatch.setattr(gm, "forward", real_forward)
    eager_cache = QuantizedKVCache.create(cfg, 3, 128, device="cuda")
    want, logits = chip_smoke.eager_generate(params, cfg, prompts, 24, eager_cache)
    assert torch.equal(got, want)
    assert torch.equal(seen[tuple(logits.shape)], logits)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, name), getattr(eager_cache, name)), name
    assert counts == {**dict.fromkeys(counts, 0), **per_step(params, cfg, 23),
                      "flash_attention": cfg.num_layers}


def test_decode_step_replays_count_exactly(card):
    """make_prefill, then 9 calls of one make_decode_step: the first runs
    a step eagerly and captures it, the other 8 replay; the emitted ids
    equal the eager loop's, one graph is held, and each replay counts its
    launches once."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine import make_decode_step, make_prefill
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.sampling import SamplerConfig

    params, cfg, prompts = fixture_on_card(2)
    greedy = SamplerConfig.greedy()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    state = make_prefill(cfg, greedy)(params, QuantizedKVCache.create(cfg, 2, 64, device="cuda"),
                                      prompts, 0, g)
    step = make_decode_step(cfg, greedy)
    reset_launch_counts()
    emitted = [step(params, state)[1] for _ in range(9)]
    counts = launch_counts()
    want, _ = chip_smoke.eager_generate(params, cfg, prompts, 10,
                                        QuantizedKVCache.create(cfg, 2, 64, device="cuda"))
    assert torch.equal(torch.stack(emitted, dim=1), want[:, :9])
    assert torch.equal(state.last_tokens, want[:, 9]) and int(state.pos) == 57
    assert len(step._graphs) == 1
    assert counts == {**dict.fromkeys(counts, 0), **per_step(params, cfg, 9)}


def test_generate_stream_rolls_twice_and_replays(card):
    """generate_stream on the fixture with a dense bf16 cache of 56
    positions, 4 sinks, a 40-token prompt and 48 tokens: the cache rolls
    three times (13 positions each) under the same graph, and the ids equal
    the eager loop's on the card."""
    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.engine import generate_stream
    from metalchat_tpu_torch.sampling import SamplerConfig

    params, cfg, fixture = chip_smoke.fixture_params(torch, "cuda")
    prompt = np.load(fixture / "eval_tokens.npy")[chip_smoke.STREAM_FIXTURE_PROMPT][:40].tolist()

    def cache():
        return KVCache.create(cfg, 1, 56, dtype=torch.bfloat16, device="cuda")

    got = list(generate_stream(params, cfg, prompt, max_new_tokens=48,
                               sampler=SamplerConfig.greedy(), cache=cache(), sink_tokens=4))
    want, rolls = chip_smoke.eager_stream(params, cfg, prompt, 48, cache(), 4)
    assert rolls >= 2 and len(got) == 48 and len(set(got)) > 4
    assert got == want


def test_stochastic_generate_repeats_with_its_seed(card):
    """A stochastic sampler (temperature, top-k, top-p) through the graph:
    the same seed gives the same ids in two calls (the generator is
    registered with the graph, so each replay draws anew), another seed
    other ids."""
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.sampling import SamplerConfig

    params, cfg, prompts = fixture_on_card()
    sampler = SamplerConfig(temperature=1.0, top_k=40, top_p=0.95)
    runs = [generate(params, cfg, prompts, max_new_tokens=32, sampler=sampler, seed=seed,
                     quantized_kv=True) for seed in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    # Replays draw fresh numbers: the rows do not settle into one repeated id.
    assert all(len(set(r.tolist())) > 4 for r in runs[0])


def test_sample_batched_replays_continue_the_generator(card):
    """`sample_batched` with device tensors (top-k + top-p rows beside a
    greedy row) captured in a CUDA graph with its generator registered: an
    eager call, three replays, then an eager call draw the ids that five
    eager calls draw from the same seed."""
    from metalchat_tpu_torch.ops._build import CountedGraph, warm_up
    from metalchat_tpu_torch.sampling import sample_batched, sampling_branch

    _, gen, dev = card
    logits = torch.randn((4, 1000), generator=gen, device=dev) * 3
    temps, ks, ps = (np.array([0.0, 0.8, 1.0, 0.7], np.float32),
                     np.array([0, 20, 0, 5], np.int32), np.array([1.0, 0.9, 0.8, 1.0], np.float32))
    branch = sampling_branch(temps, ks, ps)
    settings = [torch.from_numpy(a).to(dev) for a in (temps, ks, ps)]
    ref = torch.Generator(device=dev).manual_seed(3)
    want = [sample_batched(logits, ref, *settings, branch) for _ in range(5)]
    g = torch.Generator(device=dev).manual_seed(3)
    out = torch.zeros((4,), dtype=torch.int64, device=dev)

    def step():
        out.copy_(sample_batched(logits, g, *settings, branch))

    warm_up(step, dev)
    got = [out.clone()]
    graph = CountedGraph()
    graph.graph.register_generator_state(g)
    graph.capture(step)
    for _ in range(3):
        graph.replay()
        got.append(out.clone())
    got.append(sample_batched(logits, g, *settings, branch))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len({tuple(t.tolist()) for t in got}) > 1


@pytest.mark.parametrize("mode", list(chip_smoke.SERVE_FIXTURE_MODES))
def test_engine_graph_route_matches_eager_loop(card, mode):
    """The engine on the fixture (4 greedy requests, 3 slots, bursts of 4):
    the graph route (one warm-up step and capture, then replays) gives the
    eager-loop engine's ids, cache tensors and launch counts bit for bit;
    one graph is held, and a later run only replays it."""
    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    params, cfg, fixture = chip_smoke.fixture_params(torch, "cuda", torch.float32)
    tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
    prompts = [tokens[1000 + 100 * i:1000 + 100 * i + n].tolist()
               for i, n in enumerate((5, 70, 35, 15))]
    kw = {**chip_smoke.SERVE_FIXTURE, **chip_smoke.SERVE_FIXTURE_MODES[mode]}
    runs = []
    for engine in (ContinuousBatchingEngine(params, cfg, **kw),
                   chip_smoke.eager_burst_engine(params, cfg, **kw)):
        reset_launch_counts()
        done = engine.run([Request(prompt=p, max_new_tokens=16) for p in prompts])
        runs.append((engine, [c.tokens for c in done.values()], launch_counts()))
    (graph_engine, got, got_counts), (eager_engine, want, want_counts) = runs
    assert got == want and got_counts == want_counts
    for name, t in chip_smoke.cache_tensors(graph_engine).items():
        assert torch.equal(t, chip_smoke.cache_tensors(eager_engine)[name]), name
    graph = graph_engine._graphs["greedy"]
    assert list(graph_engine._graphs) == ["greedy"]
    graph_engine.run([Request(prompt=prompts[0], max_new_tokens=8)])
    assert graph_engine._graphs == {"greedy": graph}


# Row 1 with a device index (Mixtral's routed experts): every entry against
# the plain version; one call in a CUDA graph follows an index rewritten on
# the card between replays.
def test_a8_matvec_indexed_kernel_and_graph(card):
    sm, gen, dev = card
    chip_smoke.check_a8_indexed(sm, [("w1", 512, 256), ("w2", 256, 512)], (1, 2, 5),
                                (0, 3, 9, 15), 16, gen, dev)


def test_a8_matvec_indexed_past_2_31_bytes(card):
    """Entry 255 of a [256, 4096, 7168] stack (w2 of Mixtral-8x7B, flattened)
    starts 7.49e9 bytes in: the kernel's 64-bit offset reaches it."""
    sm, gen, dev = card
    assert 255 * 4096 * 7168 > 2 ** 31
    chip_smoke.check_a8_indexed(sm, [("w2", 4096, 14336)], (1,), (0, 255), 256, gen, dev)


def test_a8_matvec_index_contract(card):
    """A CPU index with CUDA rows raises (it is never read on the host), as
    do an index of another dtype or shape and a norm prologue."""
    from metalchat_tpu_torch.ops.a8_matvec import quant_matvec_stacked_fused

    _, gen, dev = card
    p = torch.randint(-128, 128, (4, 64, 16), generator=gen, device=dev, dtype=torch.int8)
    s = torch.ones((4, 1, 64), device=dev)
    x = torch.randn((1, 32), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="index is on cpu"):
        quant_matvec_stacked_fused(x, p, s, torch.tensor(1, dtype=torch.int32), bits=4)
    for bad in (torch.tensor(1, device=dev), torch.tensor([1], dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match="0-d int32"):
            quant_matvec_stacked_fused(x, p, s, bad, bits=4)
    with pytest.raises(ValueError, match="no norm"):
        quant_matvec_stacked_fused(x, p, s, torch.tensor(1, dtype=torch.int32, device=dev),
                                   bits=4, norm_stack=torch.ones((4, 32), device=dev,
                                                                 dtype=torch.bfloat16),
                                   norm_eps=1e-5)


@pytest.mark.parametrize("b", [1, 3])
def test_moe_generate_graph_matches_eager_loop(card, b):
    """A small W4A8 Mixtral through generate: 1 row routes each pair through
    the indexed matvec (device indices, no host read, one captured step), 3
    rows run every expert at host indices; ids and cache equal the eager
    loop's bit for bit."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import MixtralConfig
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import quantize_params

    _, gen, dev = card
    cfg = MixtralConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=128,
                        num_experts=8)
    params = fuse_projections(quantize_params(init_random_params(cfg, device=dev), bits=4,
                                              group_size=None, act_bits=8,
                                              quantize_lm_head=True), cfg)
    prompts = torch.randint(0, 512, (b, 40), generator=gen, device=dev)
    reset_launch_counts()
    cache = QuantizedKVCache.create(cfg, b, 64, device=dev)
    got = generate(params, cfg, prompts, max_new_tokens=12, cache=cache)
    counts = launch_counts()
    eager_cache = QuantizedKVCache.create(cfg, b, 64, device=dev)
    want, _ = chip_smoke.eager_generate(params, cfg, prompts, 12, eager_cache)
    assert torch.equal(got, want)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, name), getattr(eager_cache, name)), name
    want_counts = {**dict.fromkeys(counts, 0), "flash_attention": 2,
                   "decode_attention_update": 2 * 11}
    want_counts.update({k: n * 11 for k, n in chip_smoke.matvec_calls(cfg, b).items()})
    assert counts == want_counts


def test_chat_session_replays_one_graph(card):
    """The chat `Interpreter` on the fixture (W4A8, bf16, a dense cache of
    96 positions, 4 sinks): two turns whose second reply rolls the cache,
    one captured decode step for the session, ids, pos and cache equal to
    `chip_smoke.eager_chat` on the card bit for bit."""
    from metalchat_tpu_torch.chat.interpreter import Interpreter
    from metalchat_tpu_torch.sampling import SamplerConfig
    from metalchat_tpu_torch.text import load_tiktoken_model

    params, cfg, fixture = chip_smoke.fixture_params(torch, "cuda")
    tok = load_tiktoken_model(fixture / "tokenizer.model")
    turns = [((("user", "def f(x):\n    "),), 24), ((("user", "return x"),), 24)]
    session = Interpreter(params, cfg, tok, sampler=SamplerConfig.greedy(), max_seq_len=96,
                          sink_tokens=4, max_reply_tokens=24)
    got = []
    for messages, _ in turns:
        for role, text in messages:
            session.write(text, role=role)
        got.append(list(session.read_tokens()))
    want, pos, cache, rolls = chip_smoke.eager_chat(params, cfg, tok, turns, 96, 4)
    assert got == want and session.pos == pos and rolls >= 1
    assert session.captures == 1
    assert torch.equal(session.cache.k, cache.k) and torch.equal(session.cache.v, cache.v)


# -- speculative decoding (engine/speculative.py) ---------------------------------

@pytest.mark.parametrize("kv", ["act", "int8"])
def test_window_captured_at_a_tensor_position(card, kv):
    """decode_step over a 4-token window at a 0-d device position, captured
    in a CUDA graph and replayed at two positions rewritten between the
    replays: logits and cache bit for bit those of the eager window at the
    int position (the cache rows written at device indices)."""
    from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
    from metalchat_tpu_torch.models.decode import decode_step
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops._build import CountedGraph, warm_up

    params, cfg, prompts = fixture_on_card(rows=1)

    def fresh():
        if kv == "int8":
            cache = QuantizedKVCache.create(cfg, 1, 96, device="cuda")
        else:
            cache = KVCache.create(cfg, 1, 96, device="cuda")
        forward(params, cache, prompts, 0, cfg)
        return cache

    window = prompts[:, 40:44].clone()
    eager = []
    for p in (48, 52):
        cache = fresh()
        logits, _ = decode_step(params, cache, window, p, cfg)
        eager.append((logits, cache))
    cache = fresh()
    pos = torch.tensor(48, dtype=torch.int32, device="cuda")

    def body():
        return decode_step(params, cache, window, pos, cfg)[0]

    warm_up(body, torch.device("cuda"))
    graph = CountedGraph()
    out = graph.capture(body)
    for p, (logits, want) in zip((48, 52), eager):
        prefilled = fresh()
        for name in vars(cache):  # the prompt's rows only, as the eager window saw
            getattr(cache, name).copy_(getattr(prefilled, name))
        pos.fill_(p)
        graph.replay()
        assert torch.equal(out, logits)
        for name in vars(want):
            assert torch.equal(getattr(cache, name), getattr(want, name)), name


@pytest.mark.parametrize("force", [None, 0, 1])
def test_speculative_graph_route_matches_eager_loop(card, force):
    """speculative_generate on the fixture (W4A8 target, the same weights
    W8A8 as the draft, bf16, dense caches), 24 tokens at n_draft 4: three
    captures, one host read a round, and ids, stats and both caches equal
    to the JAX loop's (``_windows=False``) bit for bit; launches exact."""
    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.engine import speculative as spec
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    params, cfg, prompts = fixture_on_card(rows=1)
    draft, _, _ = chip_smoke.fixture_params(torch, "cuda", quant=chip_smoke.W8A8)

    def run(**kw):
        tc, dc = (KVCache.create(cfg, 1, 96, device="cuda") for _ in range(2))
        ids, stats = spec.speculative_generate(params, cfg, draft, cfg, prompts,
                                               max_new_tokens=24, n_draft=4, target_cache=tc,
                                               draft_cache=dc, _force_accept=force, **kw)
        return ids, stats, tc, dc, dict(spec.LAST_RUN)

    reset_launch_counts()
    graph = run()
    counts = launch_counts()
    eager = run(_windows=False)
    rounds = graph[4]["rounds"]
    assert graph[4] == {"rounds": rounds, "host_reads": rounds, "captures": 3}
    assert np.array_equal(graph[0], eager[0]) and graph[1] == eager[1]
    for a, b in zip(graph[2:4], eager[2:4]):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    assert counts == chip_smoke.spec_launches(counts, (params, cfg), (draft, cfg), 4, rounds, 1)


# -- GPT-2: rows 1, 3, 4, 5 and 8 at GPT-2 XL's shapes, and its paths ----------

def test_gpt2_xl_kernel_shapes(card):
    """Rows 1 (K 1600 and 6400, out 50257), 3, 4, 5 and 8 at 25 heads of 64
    (groups 1) against their plain versions, as phase kernels checks them."""
    sm, gen, dev = card
    chip_smoke.gpt2_kernel_checks(sm, gen, dev)


@pytest.mark.parametrize("kv", ["int8", "act"])
def test_gpt2_generate_graph_matches_eager_loop(card, kv):
    """A small GPT-2 W8A8 (chip_smoke.make_gpt2_params at 2 layers, hidden
    256, 4 heads of 64) through `generate` on an int8 or a bf16 cache: ids
    and cache equal to the eager loop's bit for bit, launches exact."""
    from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = config_from_dict(chip_smoke.GPT2_FIXTURE_JSON)
    params = chip_smoke.make_gpt2_params(cfg, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=card[1], device="cuda")

    def cache():
        if kv == "int8":
            return QuantizedKVCache.create(cfg, 2, 64, device="cuda")
        return KVCache.create(cfg, 2, 64, dtype=torch.bfloat16, device="cuda")

    reset_launch_counts()
    c = cache()
    got = generate(params, cfg, prompt, max_new_tokens=17, cache=c)
    counts = launch_counts()
    ec = cache()
    want, _ = chip_smoke.eager_generate(params, cfg, prompt, 17, ec)
    assert torch.equal(got, want)
    assert torch.equal(c.k, ec.k) and torch.equal(c.v, ec.v)
    attn = "decode_attention_update" if kv == "int8" else "decode_attention"
    assert counts == {**dict.fromkeys(counts, 0),
                      **chip_smoke.gpt2_generate_counts(cfg, 16, attn)}


def test_gpt2_fixture_card_against_cpu(card):
    """phase gpt2-fixture: f32, W8A8 and row-quantized embeddings, the card
    against the CPU's plain path."""
    chip_smoke.phase_gpt2_fixture(card[0])


def test_ppl_card_against_cpu(card):
    """phase ppl: `perplexity_delta` on the fixture, the card within
    chip_smoke.PPL_RTOL of the CPU."""
    chip_smoke.phase_ppl(card[0])


# -- quantization tooling: LoRA leaves on row 11, GPTQ on the card ---------------

QLORA_SMALL = dict(chip_smoke.LLAMA32_1B_CONFIG, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   vocab_size=512)


def test_qlora_kernel_shapes(card):
    """Row 11 at qlora-1b's shapes (int8 g32, f32 scales, natural and
    transposed, the tied head natural at out 128256), 1 and 8 rows."""
    sm, gen, dev = card
    for rows in (1, 8):
        chip_smoke.check_qmm(sm, chip_smoke.QMM_QLORA_1B, rows, gen, dev,
                             scales_dtype=torch.float32)


def test_qlora_generate_graph_matches_eager_loop(card, tmp_path):
    """A small reference-dialect QLoRA file (`write_reference_qlora`) loaded
    on the card: `generate` on an int8 cache against the eager loop, ids and
    cache bit for bit, 7 row-11 launches a layer plus the head a step; then
    the phase's native round trip (`native_roundtrip`, `roundtrip_logits`)."""
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.checkpoint import load_reference_qlora

    sm = card[0]
    cfg = config_from_dict(QLORA_SMALL).replace(max_seq_len=128)
    chip_smoke.write_reference_qlora(tmp_path / "q.safetensors", cfg, rank=8)
    params = load_reference_qlora(open_safetensors(tmp_path / "q.safetensors"), cfg,
                                  device="cuda", max_seq_len=128)
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), generator=card[1], device="cuda")
    reset_launch_counts()
    c = QuantizedKVCache.create(cfg, 1, 128, device="cuda")
    got = generate(params, cfg, prompt, max_new_tokens=17, cache=c)
    counts = launch_counts()
    ec = QuantizedKVCache.create(cfg, 1, 128, device="cuda")
    want, _ = chip_smoke.eager_generate(params, cfg, prompt, 17, ec)
    assert torch.equal(got, want)
    assert torch.equal(c.k, ec.k) and torch.equal(c.v, ec.v)
    L = cfg.num_layers
    assert counts == {**dict.fromkeys(counts, 0), "quant_matmul": 16 * (7 * L + 1),
                      "decode_attention_update": 16 * L, "flash_attention": L}
    reloaded, _, _ = chip_smoke.native_roundtrip(sm, "qlora-small", cfg, params,
                                                 tmp_path / "native.safetensors")
    chip_smoke.roundtrip_logits(sm, "qlora-small", cfg, params, reloaded, prompt)


@pytest.mark.parametrize("awq_alpha", [None, 0.5])
def test_gptq_card_against_cpu(card, awq_alpha):
    """`gptq_quantize_params` on the card (W4A8, refit_iters=2) on a small
    random Llama, with and without the AWQ fold: no factorization falls
    back, the fold's layer 0 equals the CPU's byte for byte, and layer 0's
    wk, wo, w1 and w2 against the CPU port within GPTQ_TOLERANCE."""
    from metalchat_tpu_torch.config import config_from_dict
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.quant.awq import calibration_stats
    from metalchat_tpu_torch.quant.gptq import _TAP_OF, gptq_quantize_params, hessian_tap

    sm, gen, dev = card
    cfg = config_from_dict(QLORA_SMALL).replace(max_seq_len=128)
    params = init_random_params(cfg, seed=0, dtype=torch.bfloat16, max_seq_len=128,
                                device=dev)
    calib = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device=dev)
    failures = []
    q = gptq_quantize_params(params, cfg, calib, bits=4, refit_iters=2, awq_alpha=awq_alpha,
                             failures=failures)
    assert failures and sum(int(f.sum()) for f in failures) == 0
    if awq_alpha is not None:
        chip_smoke.gptq_against_cpu_all(sm, "gptq-small", cfg, params, calib, q, awq_alpha)
        return
    hess = calibration_stats(params, cfg, calib, tap=hessian_tap)
    for name, cols in chip_smoke.GPTQ_COMPARE.items():
        chip_smoke.gptq_against_cpu(sm, "gptq-small", name, params["layers"][name][0],
                                    hess[_TAP_OF[name]][0], q["layers"][name], cols)


def test_kernel_gate_refuses_an_operand_that_requires_grad(card):
    """A kernel wrapper on the card, under grad mode, refuses an operand
    that requires grad (no kernel defines a backward); under no_grad the
    same call launches."""
    from metalchat_tpu_torch.ops.flash_attention import flash_attention

    _, gen, dev = card
    q = torch.randn((1, 32, 4, 64), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 2, 32, 64), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    with torch.enable_grad(), pytest.raises(RuntimeError, match="flash_attention: an operand"):
        flash_attention(q.requires_grad_(True), k, v, 0, scale=0.125)
    with torch.no_grad():
        assert torch.isfinite(flash_attention(q, k, v, 0, scale=0.125).float()).all()


def test_train_step_on_card_matches_cpu_and_launches_nothing(card):
    """A QLoRA train step on an int8 g32 base at the fixture's widths (bf16
    activations, remat): no kernel launched; the loss within 1e-3 and each
    adaptor gradient within 5% (relative L2) of the CPU port's, the bounds
    of `chip_smoke.TRAIN_LOSS_RTOL` and `TRAIN_GRAD_RTOL`."""
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.models.transformer import init_random_params
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import quantize_params
    from metalchat_tpu_torch.train import attach_lora, trainable_lora

    sm, gen, dev = card
    cfg = LlamaConfig(vocab_size=384, hidden_size=384, intermediate_size=1024, num_layers=2,
                      num_heads=6, num_kv_heads=3, head_dim=64, max_seq_len=128)
    params = quantize_params(init_random_params(cfg, seed=0, dtype=torch.bfloat16,
                                                device="cpu"), bits=8)
    params = attach_lora(params, rank=8, dtype=torch.bfloat16)
    for leaf in params["layers"].values():  # non-zero B: every adaptor gradient is non-zero
        if hasattr(leaf, "b"):
            leaf.b = torch.randn(leaf.b.shape, generator=torch.Generator().manual_seed(1)
                                 ).to(torch.bfloat16) * 0.02
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(2))
    reset_launch_counts()
    on_card = chip_smoke.first_step_grads(torch, cfg, chip_smoke.to_device(params, dev),
                                          tokens.to(dev), trainable_lora)
    assert not any(launch_counts().values())
    on_cpu = chip_smoke.first_step_grads(torch, cfg, params, tokens, trainable_lora)
    assert abs(on_card[0] - on_cpu[0]) <= chip_smoke.TRAIN_LOSS_RTOL * abs(on_cpu[0])
    for a, b in zip(on_card[1], on_cpu[1]):
        assert float((a - b).norm() / b.norm()) <= chip_smoke.TRAIN_GRAD_RTOL
