"""The port's speculative decoding (metalchat_tpu_torch/engine/speculative.py,
the tensor-position route of cache._write_rows, ``prompt --draft``) against
the JAX package, on the CPU.

Inputs are the JAX package's own random or trained parameters (taken to
numpy, `convert.params_from_numpy`) and prompts made with numpy from a seed.
Tolerances: ids and stats are held exactly (f32 activations and caches:
the JAX CPU backend has no bf16 dot); `breakeven_accept_rate` within 1e-12
over a grid; `measure_step_ratio` and `measure_verify_ratio` exactly, with
the timer stubbed (no wall-clock assertion); cache bytes exactly. Sampled draws are the port's own
(a ``torch.Generator``), so they are held to the target's distribution, not
to the JAX package's draws: total variation of the first token under 0.35
over 300 fixed seeds (tests/test_speculative.py's bound). On the CPU the
window steps run eagerly; the card's route runs here with a stand-in graph
whose capture records a step and whose replay runs it.
"""

import io
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine import speculative as jspec
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models import init_random_params as jinit_random_params
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import (
    KVCache,
    QuantizedKVCache,
    _write_rows,
    update_stacked_layer_cache_quantized,
)
from metalchat_tpu_torch.cli.main import main
from metalchat_tpu_torch.cli.store import Manifest, ModelStore
from metalchat_tpu_torch.config import LlamaConfig, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine import generate
from metalchat_tpu_torch.engine import speculative as spec
from metalchat_tpu_torch.models.decode import decode_step
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.ops._build import CountedGraph
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"


def jcfg(layers):
    """tests/test_speculative.py's tiny configs."""
    return JLlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                        num_layers=layers, num_heads=4, num_kv_heads=2, head_dim=16,
                        rope_theta=10000.0, max_seq_len=128, tie_word_embeddings=False)


JTARGET, JDRAFT = jcfg(2), jcfg(1)


def port_cfg(c):
    return LlamaConfig(**{f: getattr(c, f) for f in LlamaConfig.__dataclass_fields__})


TARGET, DRAFT = port_cfg(JTARGET), port_cfg(JDRAFT)


def port(jparams):
    return params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def prompt_of(seed=0, m=8):
    return np.random.default_rng(seed).integers(1, 96, (1, m)).astype(np.int32)


def tiny(target_seed, draft_seed):
    """(JAX target, JAX draft, port target, port draft) in f32."""
    jt = jinit_random_params(JTARGET, seed=target_seed, dtype=jnp.float32)
    jd = jinit_random_params(JDRAFT, seed=draft_seed, dtype=jnp.float32)
    return jt, jd, port(jt), port(jd)


def both(jt, jtc, jd, jdc, pt, ptc, pd, pdc, prompt, length=128, **kw):
    """The JAX function and the port's on the same inputs, dense f32 caches
    of ``length``: ((ids, stats) of JAX, (ids, stats) of the port)."""
    want = jspec.speculative_generate(
        jt, jtc, jd, jdc, jnp.asarray(prompt),
        target_cache=JKVCache.create(jtc, 1, length, dtype=jnp.float32),
        draft_cache=JKVCache.create(jdc, 1, length, dtype=jnp.float32), **kw)
    got = spec.speculative_generate(
        pt, ptc, pd, pdc, torch.from_numpy(prompt),
        target_cache=KVCache.create(ptc, 1, length, dtype=torch.float32, device="cpu"),
        draft_cache=KVCache.create(pdc, 1, length, dtype=torch.float32, device="cpu"), **kw)
    return want, got


def assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    assert got[1] == want[1]


def target_greedy(jt, prompt, n):
    cache = JKVCache.create(JTARGET, 1, 128, dtype=jnp.float32)
    return np.asarray(jgenerate(jt, JTARGET, jnp.asarray(prompt), max_new_tokens=n,
                                cache=cache))[0]


# -- greedy against the JAX function ---------------------------------------------

@pytest.mark.parametrize("n_draft", [2, 4])
def test_weak_draft_matches_jax(n_draft):
    """A different, weak draft: the JAX function's ids and stats, and the
    target's greedy decode; one host read a round."""
    jt, jd, pt, pd = tiny(0, 99)
    prompt = prompt_of(0)
    want, got = both(jt, JTARGET, jd, JDRAFT, pt, TARGET, pd, DRAFT, prompt,
                     max_new_tokens=12, n_draft=n_draft)
    assert_same(want, got)
    np.testing.assert_array_equal(got[0], target_greedy(jt, prompt, 12))
    assert got[1]["iterations"] >= 1
    assert spec.LAST_RUN["host_reads"] == spec.LAST_RUN["rounds"] == got[1]["iterations"]
    mine = generate(pt, TARGET, torch.from_numpy(prompt).long(), max_new_tokens=12,
                    max_seq_len=128)
    np.testing.assert_array_equal(got[0], mine.numpy()[0])


def test_perfect_draft_accepts_everything():
    jt, _, pt, _ = tiny(1, 1)
    prompt = prompt_of(1)
    want, got = both(jt, JTARGET, jt, JTARGET, pt, TARGET, pt, TARGET, prompt,
                     max_new_tokens=16, n_draft=4)
    assert_same(want, got)
    np.testing.assert_array_equal(got[0], target_greedy(jt, prompt, 16))
    assert got[1]["accept_rate"] == 1.0 and got[1]["tokens_per_iteration"] >= 3.5


def test_eos_stops():
    jt, jd, pt, pd = tiny(2, 3)
    prompt = prompt_of(2)
    ref = target_greedy(jt, prompt, 16)
    eos = int(ref[4])
    want, got = both(jt, JTARGET, jd, JDRAFT, pt, TARGET, pd, DRAFT, prompt,
                     max_new_tokens=16, n_draft=3, eos_ids=(eos,))
    assert_same(want, got)
    ids = got[0].tolist()
    assert eos in ids and ids.index(eos) <= 4
    np.testing.assert_array_equal(got[0], ref[:len(ids)])


@pytest.mark.parametrize("force", [0, 1, 3])
def test_force_accept_matches_jax(force):
    """The benchmark hook at 0, 1 and n_draft - 1 accepted drafts a round:
    the JAX function's ids and stats (a stale buffer would show at k < n-1),
    through the window steps and through the host loop."""
    jt, jd, pt, pd = tiny(0, 99)
    prompt = prompt_of(5)
    want, got = both(jt, JTARGET, jd, JDRAFT, pt, TARGET, pd, DRAFT, prompt,
                     max_new_tokens=20, n_draft=4, _force_accept=force)
    assert_same(want, got)
    assert got[1]["accepted"] == force * got[1]["iterations"]
    loop = spec.speculative_generate(
        pt, TARGET, pd, DRAFT, torch.from_numpy(prompt), max_new_tokens=20, n_draft=4,
        _force_accept=force, _windows=False,
        target_cache=KVCache.create(TARGET, 1, 128, dtype=torch.float32, device="cpu"),
        draft_cache=KVCache.create(DRAFT, 1, 128, dtype=torch.float32, device="cpu"))
    assert_same(want, loop)


def test_budget_stops_at_the_cache_end():
    """A cache too short for the budget: the loop stops where JAX's does
    (``pos + n_draft + 1 < total``) with the default caches' size rule."""
    jt, jd, pt, pd = tiny(0, 99)
    prompt = prompt_of(6, m=20)
    want = jspec.speculative_generate(jt, JTARGET, jd, JDRAFT, jnp.asarray(prompt),
                                      max_new_tokens=64, n_draft=4, max_seq_len=40)
    got = spec.speculative_generate(pt, TARGET, pd, DRAFT, torch.from_numpy(prompt),
                                    max_new_tokens=64, n_draft=4, max_seq_len=40)
    assert_same(want, got)
    assert len(got[0]) < 20


# -- the trained fixture -----------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    """The fixture in f32: W4A8 fused target and W8A8 draft, JAX and port,
    the port's config and the eval tokens."""
    jc = jload_config(FIXTURE / "config.json")
    dense = jload_params(jopen(FIXTURE), jc, dtype=jnp.float32, max_seq_len=256)
    jt = jfuse(jquantize_params(dense, bits=4, group_size=None, act_bits=8), jc)
    jd = jquantize_params(dense, bits=8, group_size=None, act_bits=8)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    return jc, jt, jd, load_config(FIXTURE / "config.json"), port(jt), port(jd), tokens


def test_fixture_w4a8_target_w8a8_draft_matches_jax(fixture):
    """``eval_tokens[1440:1488]`` (the start of the tie-free slice), 24
    tokens at n_draft 4: the JAX function's ids and stats, and the target's
    greedy decode; the draft, a requantized target, is accepted often."""
    jc, jt, jd, cfg, pt, pd, tokens = fixture
    prompt = tokens[None, 1440:1488]
    want, got = both(jt, jc, jd, jc, pt, cfg, pd, cfg, prompt, length=96,
                     max_new_tokens=24, n_draft=4)
    assert_same(want, got)
    greedy = jgenerate(jt, jc, jnp.asarray(prompt), max_new_tokens=24,
                       cache=JKVCache.create(jc, 1, 96, dtype=jnp.float32))
    np.testing.assert_array_equal(got[0], np.asarray(greedy)[0])
    assert got[1]["accept_rate"] > 0.5


# -- sampled mode ------------------------------------------------------------------

def test_rejection_sampling_preserves_distribution():
    """The first token's empirical distribution over 300 fixed seeds against
    the target's softmax at temperature 1, with a biased draft."""
    _, _, pt, pd = tiny(4, 5)
    prompt = torch.from_numpy(prompt_of(4, m=4))
    cache = KVCache.create(TARGET, 1, 64, dtype=torch.float32, device="cpu")
    logits, _ = forward(pt, cache, prompt, 0, TARGET)
    p_direct = spec._softmax_t(logits[0, -1], 1.0).numpy()
    counts = np.zeros(TARGET.vocab_size)
    for s in range(300):
        out, _ = spec.speculative_generate(pt, TARGET, pd, DRAFT, prompt, max_new_tokens=3,
                                           n_draft=3, temperature=1.0, seed=s,
                                           max_seq_len=64)
        counts[int(out[0])] += 1
    tv = 0.5 * np.abs(counts / 300 - p_direct).sum()
    assert tv < 0.35, tv


def test_sampled_mode_runs_and_terminates():
    _, _, pt, pd = tiny(6, 7)
    prompt = torch.from_numpy(prompt_of(6))
    out, stats = spec.speculative_generate(pt, TARGET, pd, DRAFT, prompt, max_new_tokens=10,
                                           n_draft=4, temperature=0.8, seed=42)
    again, _ = spec.speculative_generate(pt, TARGET, pd, DRAFT, prompt, max_new_tokens=10,
                                         n_draft=4, temperature=0.8, seed=42)
    assert len(out) == 10 and ((0 <= out) & (out < 96)).all()
    assert 0.0 <= stats["accept_rate"] <= 1.0
    np.testing.assert_array_equal(out, again)
    assert spec.LAST_RUN["captures"] == 0


# -- the draft check -----------------------------------------------------------------

def test_breakeven_accept_rate():
    """tests/test_speculative.py's cases, and the JAX function over a grid."""
    f = spec.breakeven_accept_rate
    a = f(0.89, n_draft=5)
    assert a is not None and 0.9 < a < 0.99, a
    a = f(0.1, n_draft=5)
    assert a is not None and a < 0.6, a
    assert f(0.0, n_draft=5, verify_rel=1.0) == 0.0
    assert f(1.2, n_draft=3) is None
    lo, hi = f(0.3, n_draft=5), f(0.3, n_draft=5, sync_rel=2.0)
    assert hi is None or hi > lo
    for ratio in np.linspace(0.0, 1.3, 27):
        for n in (2, 3, 4, 5, 8, 16):
            for verify in (1.0, 1.16, 2.0):
                for sync in (0.0, 0.5, 2.0):
                    kw = dict(n_draft=n, verify_rel=verify, sync_rel=sync)
                    want = jspec.breakeven_accept_rate(float(ratio), **kw)
                    got = f(float(ratio), **kw)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert abs(got - want) <= 1e-12


def test_measure_step_ratio_with_a_stubbed_timer(monkeypatch):
    """Each model's steps cost ``overhead + steps · t`` on the stub's clock
    (t a power of two, so the marginals are exact): the ratio is
    t_draft / t_target exactly, and the steps really ran."""
    _, _, pt, pd = tiny(0, 99)
    cost = {TARGET.num_layers: 2.0 ** -9, DRAFT.num_layers: 2.0 ** -11}
    calls = []
    real = spec._timed

    def timed(step, params, state, steps):
        calls.append((step.config.num_layers, steps))
        real(step, params, state, steps)
        return 0.5 + steps * cost[step.config.num_layers]

    monkeypatch.setattr(spec, "_timed", timed)
    r = spec.measure_step_ratio(pt, TARGET, pd, DRAFT, seq_len=64, steps_lo=2, steps_hi=10)
    assert r == 0.25
    assert calls == [(2, 2), (2, 10)] * 4 + [(1, 2), (1, 10)] * 4


def test_measure_step_ratio_runs_the_step():
    """Unstubbed on the CPU: a positive finite ratio (no bound on its value:
    the host clock of a loaded machine says little)."""
    _, _, pt, pd = tiny(0, 99)
    r = spec.measure_step_ratio(pt, TARGET, pd, DRAFT, seq_len=32, steps_lo=1, steps_hi=3)
    assert np.isfinite(r) and r > 0


def test_measure_verify_ratio_with_a_stubbed_timer(monkeypatch):
    """The verify window's steps cost ``overhead + steps · t_v`` on the
    stub's clock and the target's one-token step ``overhead + steps · t``
    (powers of two): the ratio is t_v / t exactly. The window step really
    ran: `forward` on ``n_draft`` tokens at a device position (the route
    `GreedyWindows` verifies on), the one-token step on one."""
    _, _, pt, _ = tiny(0, 99)
    cost = {True: 2.0 ** -8, False: 2.0 ** -10}
    calls, fed = [], []
    real_timed, real_forward = spec._timed, spec.forward

    def timed(step, params, state, steps):
        window = step.forward_fn is not None
        calls.append((window, steps))
        real_timed(step, params, state, steps)
        return 0.5 + steps * cost[window]

    def forward(params, cache, tokens, start_pos, config, **kw):
        fed.append((tuple(tokens.shape), torch.is_tensor(start_pos)))
        return real_forward(params, cache, tokens, start_pos, config, **kw)

    monkeypatch.setattr(spec, "_timed", timed)
    monkeypatch.setattr(spec, "forward", forward)
    r = spec.measure_verify_ratio(pt, TARGET, n_draft=3, seq_len=64, steps_lo=2, steps_hi=10)
    assert r == 4.0
    assert calls == [(False, 2), (False, 10)] * 4 + [(True, 2), (True, 10)] * 4
    assert set(fed) == {((1, 3), True)}


def test_measure_verify_ratio_runs_the_window():
    """Unstubbed on the CPU: a positive finite ratio (no bound on its value:
    the host clock of a loaded machine says little)."""
    _, _, pt, _ = tiny(0, 99)
    r = spec.measure_verify_ratio(pt, TARGET, n_draft=4, seq_len=32, steps_lo=1, steps_hi=3)
    assert np.isfinite(r) and r > 0


# -- the card's route on the CPU ---------------------------------------------------------

class _Recorder:
    def __init__(self, events):
        self.events, self.fn = events, None

    def replay(self):
        self.events.append("replay")
        self.fn()


class ExecutingGraph(CountedGraph):
    """`capture` records the step and runs nothing (a capture on the card
    runs nothing); `replay` runs it."""

    events: list = []

    def __init__(self):
        super().__init__(graph=_Recorder(self.events))

    def capture(self, fn):
        self.events.append("capture")
        self.graph.fn = fn


@pytest.mark.parametrize("force", [None, 0, 1])
def test_graph_route_equals_eager(monkeypatch, force):
    """The window steps through the stand-in graph route: three captures
    (draft window, draft step, verify), replays after, one host read a
    round; ids, stats and both caches equal the eager route's and the host
    loop's bit for bit."""
    jt, jd, pt, pd = tiny(0, 99)
    prompt = torch.from_numpy(prompt_of(7))
    kw = dict(max_new_tokens=20, n_draft=4, _force_accept=force)

    def run(**extra):
        tc = KVCache.create(TARGET, 1, 64, dtype=torch.float32, device="cpu")
        dc = KVCache.create(DRAFT, 1, 64, dtype=torch.float32, device="cpu")
        ids, stats = spec.speculative_generate(pt, TARGET, pd, DRAFT, prompt, target_cache=tc,
                                               draft_cache=dc, **kw, **extra)
        return ids, stats, tc, dc, dict(spec.LAST_RUN)

    eager = run()
    loop = run(_windows=False)
    events = []
    monkeypatch.setattr(ExecutingGraph, "events", events)
    monkeypatch.setattr(spec, "CountedGraph", ExecutingGraph)
    monkeypatch.setattr(spec.GreedyWindows, "_graph_route", lambda self, device: True)
    graph = run()
    rounds = graph[1]["iterations"]
    assert graph[4] == {"rounds": rounds, "host_reads": rounds, "captures": 3}
    assert eager[4] == {"rounds": rounds, "host_reads": rounds, "captures": 0}
    assert loop[4]["host_reads"] == 4 * rounds
    # Round 1: window (eager), step (eager), step (capture taken on the
    # eager run's heels), verify; each later round replays all four.
    assert events == ["capture", "capture", "replay", "capture"] + ["replay"] * 4 * (rounds - 1)
    for other in (eager, loop):
        np.testing.assert_array_equal(graph[0], other[0])
        assert graph[1] == other[1]
        for a, b in ((graph[2], other[2]), (graph[3], other[3])):
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


# -- the tensor-position cache write ----------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "int8"])
@pytest.mark.parametrize("position", ["0-d", "per-row"])
def test_write_rows_tensor_route_writes_the_int_routes_bytes(kind, position):
    """The same bytes as slices at host ints, payloads and scales."""
    rng = np.random.default_rng(11)
    b, nkv, t, hd, s = 3, 2, 40, 16, 4
    starts = [5, 5, 5] if position == "0-d" else [0, 17, 36]
    k = torch.from_numpy(rng.standard_normal((b, s, nkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, nkv, hd)).astype(np.float32))
    if kind == "dense":
        def fresh():
            return [torch.from_numpy(rng.standard_normal((1, b, nkv, t, hd)).astype(np.float32))
                    for _ in range(2)]
        want = fresh()
        got = [x.clone() for x in want]
        for i, p in enumerate(starts):
            want[0][0, i:i + 1, :, p:p + s] = k[i:i + 1].transpose(1, 2)
            want[1][0, i:i + 1, :, p:p + s] = v[i:i + 1].transpose(1, 2)
        pos = (torch.tensor(5) if position == "0-d"
               else torch.tensor(starts, dtype=torch.int32))
        _write_rows(got[0][0], k.transpose(1, 2), pos)
        _write_rows(got[1][0], v.transpose(1, 2), pos)
    else:
        base = QuantizedKVCache.create(LlamaConfig(num_layers=1, num_kv_heads=nkv,
                                                   head_dim=hd), b, t, device="cpu")
        want = [x.clone() for x in (base.k, base.v, base.k_scale, base.v_scale)]
        got = [x.clone() for x in want]
        for i, p in enumerate(starts):
            one = [x[:, i:i + 1] for x in want]
            update_stacked_layer_cache_quantized(*one, k[i:i + 1], v[i:i + 1], 0, p)
        pos = (torch.tensor(5, dtype=torch.int32) if position == "0-d"
               else torch.tensor(starts))
        update_stacked_layer_cache_quantized(*got, k, v, 0, pos)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_decode_step_window_at_a_tensor_position():
    """decode_step at S = 4 on dense and int8 caches: the same logits and
    cache bytes at a 0-d tensor position as at the int."""
    jt, _, pt, _ = tiny(0, 99)
    prompt = torch.from_numpy(prompt_of(8, m=10)).long()
    window = torch.from_numpy(prompt_of(9, m=4)).long()
    for make in (lambda: KVCache.create(TARGET, 1, 32, dtype=torch.float32, device="cpu"),
                 lambda: QuantizedKVCache.create(TARGET, 1, 32, device="cpu")):
        outs = []
        for pos in (10, torch.tensor(10, dtype=torch.int32)):
            cache = make()
            forward(pt, cache, prompt, 0, TARGET)
            logits, _ = decode_step(pt, cache, window, pos, TARGET)
            outs.append((logits, cache))
        (a, ca), (b, cb) = outs
        assert torch.equal(a, b)
        for name in vars(ca):
            assert torch.equal(getattr(ca, name), getattr(cb, name))


# -- the CLI --------------------------------------------------------------------------

def test_cli_prompt_draft_gives_the_greedy_reply(tmp_path, monkeypatch):
    """model pull of the fixture, a greedy manifest, then ``prompt --draft``
    with the fixture as its own draft: the reply of ``prompt`` alone, and
    the accept rate and step-ratio lines on stderr."""
    monkeypatch.setenv("METALCHAT_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    assert main(["model", "pull", str(FIXTURE), "--name", "pyllama"]) == 0
    model = ModelStore().find("pyllama")
    manifest = Manifest.load(model.path / Manifest.FILENAME)
    manifest.inference["sampling"] = {"temperature": 0}
    manifest.save(model.path / Manifest.FILENAME)
    argv = ["prompt", "pyllama", "-c", "def main():", "--max-tokens", "24",
            "--max-seq-len", "256", "--device", "cpu"]
    outs = []
    for extra in ([], ["--draft", "pyllama", "--n-draft", "4"]):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            assert main(argv + extra) == 0
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[1][0] == outs[0][0] and len(outs[0][0]) > 1
    assert "[speculative] accept_rate=1.00" in outs[1][1]
    assert "step ratio" in outs[1][1] or "WARNING" in outs[1][1]
