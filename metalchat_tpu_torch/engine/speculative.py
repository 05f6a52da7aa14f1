"""Speculative decoding: a small draft model proposes, the target verifies
(port of the JAX package's ``engine/speculative.py``, batch 1).

Each round the draft proposes ``n_draft - 1`` tokens one at a time, the
target scores the window ``[last, d_1 .. d_{n-1}]`` in one forward, and the
longest verified prefix is accepted, with the target's own token after it.
Greedy mode accepts while a draft equals the target's argmax, so its output
is the target's greedy decode: exactly in f32; in bf16 a verify window's
logits (row 1 at 2-16 rows, the reference attention, which rounds its
softmax weights to the cache's dtype) may round apart from a one-token
step's. Sampled mode is Leviathan-style rejection sampling, whose marginal
is the target's distribution.

Cache rules, as in the JAX loop: both caches are plain dense caches and
nothing rewinds them. Entries past the accepted length go stale and are
masked by length. The draft's cache lags one key (the last proposal's key
is never written), so each round opens the draft with the 2-token window
``[prev_last, last]`` at ``pos - 1``, which backfills it.

Greedy rounds (`GreedyWindows`) run three steps over fixed device buffers:
the draft's 2-token window, its one-token step and the target's
``n_draft``-token verify. The draft's argmax feeds its next step on the
device, and a round reads the host once: the drafts beside the target's
argmaxes. On the card each step is captured once into a CUDA graph (after
one eager warm-up run) and replayed; on the CPU each runs eagerly. Sampled
rounds, and greedy rounds whose windows `forward` would not take through
`decode_step` (more than 16 tokens, a paged cache), run the JAX loop as it
is: eager `forward` calls at host positions, a host read for each draft.
Draws come from one ``torch.Generator`` (``argmax(p / q)``, ``q ~ Exp(1)``,
as `sampling.sample` draws), so they are the port's own and not the JAX
package's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.engine.generate import DecodeState, DecodeStep
from metalchat_tpu_torch.models.decode import supports_fast_decode
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.ops._build import CountedGraph, warm_up
from metalchat_tpu_torch.sampling import SamplerConfig

# The last `speculative_generate` call's rounds, host reads made in its
# rounds and CUDA graphs captured (the prefill's one read is not a round's).
LAST_RUN: Dict[str, int] = {"rounds": 0, "host_reads": 0, "captures": 0}


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float) -> torch.Tensor:
    """Argmax at temperature 0, else a draw from softmax(logits / T)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    p = torch.softmax(logits.float() / temperature, dim=-1)
    q = torch.empty_like(p).exponential_(1.0, generator=generator)
    return torch.argmax(p / q, dim=-1)


def _softmax_t(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 0.0:  # a point mass on the argmax
        return torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                           logits.shape[-1]).float()
    return torch.softmax(logits.float() / temperature, dim=-1)


def breakeven_accept_rate(step_ratio: float, n_draft: int = 4, verify_rel: float = 1.16,
                          sync_rel: float = 0.0) -> Optional[float]:
    """Per-draft accept rate α at which speculative decoding breaks even.

    Costs in units of one target decode step: a round costs (n_draft − 1)·
    (step_ratio + sync_rel) + verify_rel + sync_rel and emits E(α) =
    Σ_{i<n_draft} α^i tokens; plain decode pays 1 + sync_rel a token.
    ``verify_rel`` is the verify window's cost in target steps: the
    default 1.16 is the JAX package's default, measured on a TPU;
    `measure_verify_ratio` measures it on the running device. Returns None
    when even α = 1 loses."""
    cost = (n_draft - 1) * (step_ratio + sync_rel) + verify_rel + sync_rel
    need = cost / (1.0 + sync_rel)   # emitted tokens a round to break even
    if need >= n_draft:              # E(1) = n_draft is the ceiling
        return None
    if need <= 1.0:
        return 0.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        e = sum(mid ** i for i in range(n_draft))
        lo, hi = (mid, hi) if e < need else (lo, mid)
    return (lo + hi) / 2


def _cache_tensors(cache) -> Tuple[torch.Tensor, ...]:
    return tuple(v for v in vars(cache).values() if torch.is_tensor(v))


class GreedyWindows:
    """The device side of greedy rounds. Buffers: ``args`` = (prev_last,
    last, pos), written by one copy a round; ``window [1, n_draft]`` = the
    verify window ``[last, d_1 .. d_{n-1}]``; the draft step's token
    ``cur [1, 1]`` and position ``dpos``; ``out`` = the drafts, then the
    target's argmax at each window position.

    On a CUDA device each step runs once eagerly (`warm_up`), is captured
    into a `CountedGraph` keyed by its name and the buffers' data pointers,
    and is replayed from then on; elsewhere it runs eagerly."""

    def __init__(self, target_params, target_config: ModelConfig, target_cache,
                 draft_params, draft_config: ModelConfig, draft_cache, n_draft: int):
        dev = target_params["final_norm"].device
        self.device, self.n_draft = dev, n_draft
        self.target = (target_params, target_config, target_cache)
        self.draft = (draft_params, draft_config, draft_cache)
        self.args = torch.zeros(3, dtype=torch.int64, device=dev)
        self._host = torch.zeros(3, dtype=torch.int64, pin_memory=dev.type == "cuda")
        self.window = torch.zeros((1, n_draft), dtype=torch.int64, device=dev)
        self.cur = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        self.dpos = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros(2 * n_draft - 1, dtype=torch.int64, device=dev)
        self.reads = 0
        held = (*_cache_tensors(target_cache), *_cache_tensors(draft_cache), self.args,
                self.window, self.cur, self.dpos, self.out)
        self._key = tuple((t.data_ptr(), tuple(t.shape)) for t in held)
        self._graphs: Dict[tuple, CountedGraph] = {}

    @staticmethod
    def applies(target_params, target_config, target_cache, draft_params, draft_config,
                draft_cache, n_draft: int) -> bool:
        """Whether `forward` takes all three windows through `decode_step`,
        which reads a tensor position on the device only."""
        def ok(params, config, cache, s):
            return supports_fast_decode(params, cache, config, torch.empty((1, s)))
        return (ok(draft_params, draft_config, draft_cache, 2)
                and ok(draft_params, draft_config, draft_cache, 1)
                and ok(target_params, target_config, target_cache, n_draft))

    def _graph_route(self, device: torch.device) -> bool:
        """Whether steps on ``device`` are captured and replayed: on the
        card. The CPU tests override it to drive the route with a stand-in
        graph."""
        return device.type == "cuda"

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def _run(self, name: str, body) -> None:
        if not self._graph_route(self.device):
            body()
            return
        key = (name, *self._key)
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        warm_up(body, self.device)
        graph = CountedGraph()
        graph.capture(body)
        self._graphs[key] = graph


    def _draft_window(self) -> None:
        params, config, cache = self.draft
        logits, _ = forward(params, cache, self.args[None, 0:2], self.args[2] - 1, config)
        self.window[:, 0:1].copy_(self.args[None, 1:2])
        if self.n_draft > 1:
            d = torch.argmax(logits[:, -1], dim=-1)[:, None]
            self.window[:, 1:2].copy_(d)
            self.cur.copy_(d)
        self.dpos.copy_(self.args[2] + 1)

    def _draft_step(self) -> None:
        params, config, cache = self.draft
        logits, _ = forward(params, cache, self.cur, self.dpos, config)
        d = torch.argmax(logits[:, -1], dim=-1)[:, None]
        # Draft d_i is fed at pos + i - 1, and d_{i+1} lands in column i + 1.
        self.window.index_copy_(1, (self.dpos - self.args[2] + 1).reshape(1), d)
        self.cur.copy_(d)
        self.dpos.add_(1)

    def _verify(self) -> None:
        params, config, cache = self.target
        logits, _ = forward(params, cache, self.window, self.args[2], config)
        n = self.n_draft
        self.out[:n - 1].copy_(self.window[0, 1:])
        self.out[n - 1:].copy_(torch.argmax(logits[0], dim=-1))

    def round(self, prev_last: int, last: int, pos: int) -> Tuple[List[int], List[int]]:
        """One round at target fill ``pos``: (drafts d_1..d_{n-1}, the
        target's argmax at each of the n window positions), one host read."""
        self._host[0], self._host[1], self._host[2] = prev_last, last, pos
        # The last round's read waited for its stream, so the staging
        # buffer is free to rewrite before this copy.
        self.args.copy_(self._host, non_blocking=True)
        self._run("draft_window", self._draft_window)
        for _ in range(self.n_draft - 2):
            self._run("draft_step", self._draft_step)
        self._run("verify", self._verify)
        vals = self.out.tolist()
        self.reads += 1
        return vals[:self.n_draft - 1], vals[self.n_draft - 1:]


def _timed(step: DecodeStep, params, state: DecodeState, steps: int) -> float:
    """Seconds for ``steps`` chained decode steps from position 0: between
    CUDA events on the card (replays of the captured step), under the host
    clock elsewhere."""
    state.last_tokens.zero_()
    state.pos.zero_()
    if state.pos.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            step.advance(params, state)
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        step.advance(params, state)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _step_time(params, config: ModelConfig, seq_len: int, steps_lo: int, steps_hi: int,
               forward_fn=None) -> float:
    """One greedy step's marginal seconds (`measure_step_ratio`):
    `engine.generate.DecodeStep` (with ``forward_fn`` in place of `forward`)
    on a dense cache of ``seq_len`` in the activation dtype, the argmax fed
    back, run ``steps_lo`` and ``steps_hi`` times in a row after one warm-up
    run of each; the median of three marginals."""
    dev = params["final_norm"].device
    state = DecodeState(
        cache=KVCache.create(config, 1, seq_len, dtype=params["final_norm"].dtype,
                             device=dev),
        last_tokens=torch.zeros(1, dtype=torch.int64, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
        generator=torch.Generator(device=dev),
        done=torch.zeros(1, dtype=torch.bool, device=dev))
    step = DecodeStep(config, SamplerConfig.greedy(), forward_fn=forward_fn)
    _timed(step, params, state, steps_lo)   # warm up (and capture) before timing
    _timed(step, params, state, steps_hi)
    marginals = []
    for _ in range(3):
        lo = _timed(step, params, state, steps_lo)
        hi = _timed(step, params, state, steps_hi)
        marginals.append((hi - lo) / (steps_hi - steps_lo))
    # The median: a single negative marginal would make a ratio meaningless.
    return max(sorted(marginals)[1], 1e-9)


@torch.no_grad()
def measure_step_ratio(target_params, target_config: ModelConfig, draft_params,
                       draft_config: ModelConfig, *, seq_len: int = 256, steps_lo: int = 2,
                       steps_hi: int = 10) -> float:
    """Measured t_draft / t_target for one decode step of each model.

    Each model's greedy one-token step (`engine.generate.DecodeStep` on a
    dense cache of ``seq_len`` in its activation dtype, the argmax fed
    back) runs ``steps_lo`` and ``steps_hi`` times in a row, after one
    warm-up run of each; the difference of the two times over ``steps_hi -
    steps_lo`` is one marginal, and the median of three marginals is the
    step time. On the card the step is a captured CUDA graph timed with
    CUDA events; on the CPU it runs eagerly under the host clock."""
    t_target = _step_time(target_params, target_config, seq_len, steps_lo, steps_hi)
    t_draft = _step_time(draft_params, draft_config, seq_len, steps_lo, steps_hi)
    return t_draft / t_target


@torch.no_grad()
def measure_verify_ratio(target_params, target_config: ModelConfig, n_draft: int = 4, *,
                         seq_len: int = 256, steps_lo: int = 2, steps_hi: int = 10) -> float:
    """Measured t_verify / t_target: the target's ``n_draft``-token verify
    window (`forward` at a device position, the route `GreedyWindows`
    verifies on) over its one-token step, both timed as
    `measure_step_ratio` times a step; the ``verify_rel`` of
    `breakeven_accept_rate` on the running device."""
    def window(params, cache, tokens, start_pos):
        return forward(params, cache, tokens.repeat(1, n_draft), start_pos, target_config)

    t_target = _step_time(target_params, target_config, seq_len, steps_lo, steps_hi)
    t_verify = _step_time(target_params, target_config, seq_len, steps_lo, steps_hi,
                          forward_fn=window)
    return t_verify / t_target


def _host_round(target, draft, prev_last: int, last: int, pos: int, n_draft: int,
                temperature: float, generator: torch.Generator, counts: Dict[str, int]):
    """One round of the JAX loop as it is: eager `forward` calls at host
    positions, a host read for each draft. Returns (drafts, the target's
    verify logits ``[n_draft, V]``, the draft distributions in sampled
    mode)."""
    (tp, tcfg, tcache), (dp, dcfg, dcache) = target, draft
    dev = tp["final_norm"].device
    drafts: List[int] = []
    qs: List[torch.Tensor] = []
    window = torch.tensor([[prev_last, last]], dtype=torch.int64, device=dev)
    logits, _ = forward(dp, dcache, window, pos - 1, dcfg)
    step_logits = logits[0, -1]
    for i in range(n_draft - 1):
        tok = int(_sample(step_logits, generator, temperature))
        counts["host_reads"] += 1
        drafts.append(tok)
        if temperature > 0.0:
            qs.append(_softmax_t(step_logits, temperature))
        if i < n_draft - 2:
            logits, _ = forward(dp, dcache, torch.tensor([[tok]], device=dev),
                                pos + 1 + i, dcfg)
            step_logits = logits[0, -1]
    verify = torch.tensor([[last] + drafts], dtype=torch.int64, device=dev)
    v_logits, _ = forward(tp, tcache, verify, pos, tcfg)
    return drafts, v_logits[0], qs


def _resolve_sampled(drafts, v_logits, qs, temperature: float, generator: torch.Generator,
                     counts: Dict[str, int]) -> Tuple[int, int]:
    """Rejection sampling over one round: (accepted drafts, next token)."""
    ps = _softmax_t(v_logits, temperature)  # [n_draft, V]
    dev = v_logits.device
    for i, d in enumerate(drafts):
        u = torch.rand((), generator=generator, device=dev)
        u, p_i, q_i = torch.stack([u, ps[i, d], qs[i][d]]).tolist()
        counts["host_reads"] += 1
        if u * q_i <= p_i:
            continue
        resid = torch.clamp(ps[i] - qs[i], min=0.0)  # resample from max(p - q, 0)
        if float(resid.sum()) <= 0.0:
            nxt = int(_sample(v_logits[i], generator, temperature))
        else:
            q = torch.empty_like(resid).exponential_(1.0, generator=generator)
            nxt = int(torch.argmax(resid / q))
        counts["host_reads"] += 2
        return i, nxt
    counts["host_reads"] += 1  # every draft accepted: the bonus token
    return len(drafts), int(_sample(v_logits[len(drafts)], generator, temperature))


@torch.no_grad()
def speculative_generate(target_params, target_config: ModelConfig, draft_params,
                         draft_config: ModelConfig, prompt: torch.Tensor, *,
                         max_new_tokens: int, n_draft: int = 4, temperature: float = 0.0,
                         max_seq_len: Optional[int] = None, eos_ids: Tuple[int, ...] = (),
                         seed: int = 0, target_cache=None, draft_cache=None,
                         _force_accept: Optional[int] = None,
                         _windows: bool = True) -> Tuple[np.ndarray, dict]:
    """Generate with draft/target speculative decoding (batch 1), on the
    device of the target's parameters.

    ``prompt`` is int ``[1, M]``. Returns (ids ``[n]`` int32, stats with
    ``iterations``, ``proposed``, ``accepted``, ``accept_rate`` and
    ``tokens_per_iteration``). ``temperature == 0`` gives the target's
    greedy decode (the module docstring says where bf16 rounds it apart),
    through `GreedyWindows` (one host read a
    round, captured steps on the card) where `forward` takes its windows
    through `decode_step`; otherwise, and in sampled mode, rounds run the
    JAX loop eagerly. The default caches are dense bf16 of ``min(max_seq_len,
    M + max_new_tokens + n_draft + 2)`` positions.

    ``_force_accept`` is for benchmarks only: exactly that many drafts are
    accepted each round, so the pipeline's cost can be measured at a chosen
    accept rate on random weights (the ids are then meaningless).
    ``_windows=False`` runs greedy rounds through the JAX loop too: the
    reference that the window steps are held to."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding is a latency feature: batch 1")
    dev = target_params["final_norm"].device
    prompt = prompt.to(device=dev, dtype=torch.int64)
    m = prompt.shape[1]
    total = max_seq_len or min(target_config.max_seq_len, m + max_new_tokens + n_draft + 2)
    if target_cache is None:
        target_cache = KVCache.create(target_config, 1, total, device=dev)
    if draft_cache is None:
        draft_cache = KVCache.create(draft_config, 1, total, device=dev)
    target = (target_params, target_config, target_cache)
    draft = (draft_params, draft_config, draft_cache)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    counts = {"rounds": 0, "host_reads": 0, "captures": 0}

    # Prefill both models on the prompt; the first token is the target's.
    t_logits, _ = forward(target_params, target_cache, prompt, 0, target_config)
    forward(draft_params, draft_cache, prompt, 0, draft_config)
    last = int(_sample(t_logits[0, -1], generator, temperature))

    windows = None
    if _windows and temperature == 0.0 and GreedyWindows.applies(*target, *draft, n_draft):
        windows = GreedyWindows(*target, *draft, n_draft)

    pos = m                        # keys 0..pos-1 are cached in the target
    prev_last = int(prompt[0, -1])
    out = [last]
    n_accepted = n_proposed = iterations = 0
    while len(out) < max_new_tokens and pos + n_draft + 1 < total:
        if eos_ids and out[-1] in eos_ids:
            break
        iterations += 1
        if windows is not None:
            drafts, greedy = windows.round(prev_last, last, pos)
        else:
            drafts, v_logits, qs = _host_round(target, draft, prev_last, last, pos,
                                               n_draft, temperature, generator, counts)
            if temperature == 0.0 or _force_accept is not None:
                greedy = torch.argmax(v_logits, dim=-1).tolist()
                counts["host_reads"] += 1
        n_proposed += len(drafts)

        if _force_accept is not None:
            k_acc = min(_force_accept, len(drafts))
            next_tok = greedy[k_acc]
        elif temperature == 0.0:
            k_acc = 0
            while k_acc < len(drafts) and drafts[k_acc] == greedy[k_acc]:
                k_acc += 1
            next_tok = greedy[k_acc]
        else:
            k_acc, next_tok = _resolve_sampled(drafts, v_logits, qs, temperature,
                                               generator, counts)
        accepted = drafts[:k_acc]
        n_accepted += k_acc
        prev_last = accepted[-1] if accepted else last
        last = next_tok
        pos += k_acc + 1
        for tok in accepted + [next_tok]:
            out.append(tok)
            if len(out) >= max_new_tokens or (eos_ids and tok in eos_ids):
                break
        if eos_ids and out[-1] in eos_ids:
            break

    counts["rounds"] = iterations
    if windows is not None:
        counts["host_reads"] = windows.reads
        counts["captures"] = windows.captures
    LAST_RUN.clear()
    LAST_RUN.update(counts)
    stats = {
        "iterations": iterations,
        "proposed": n_proposed,
        "accepted": n_accepted,
        "accept_rate": (n_accepted / n_proposed) if n_proposed else 0.0,
        "tokens_per_iteration": (len(out) - 1) / iterations if iterations else 0.0,
    }
    return np.asarray(out[:max_new_tokens], np.int32), stats
