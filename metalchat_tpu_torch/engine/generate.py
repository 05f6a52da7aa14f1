"""Generation loops (port of the JAX package's ``engine/generate.py``).

The JAX package runs the decode step as one compiled device program with
its carry donated: `generate` is a ``lax.scan`` inside one ``jit``, one host
sync for the whole generation. The counterpart here is a CUDA graph. A
`DecodeState` holds the carry in device tensors that every step updates in
place (the counterpart of donation); `make_decode_step`'s step runs once
eagerly on a CUDA state (warm-up: libraries, the kernels' arrival counters),
captures one step into a `torch.cuda.CUDAGraph`, and from then on replays
that graph on the state's own tensors. The step reads its position from
``state.pos`` on the device, so nothing in it reads back to the host.

  * `generate` — prefill, then one replay a token; the graph writes each
    emitted token into a preallocated ``[B, max_new_tokens]`` buffer at the
    column ``pos`` gives, and nothing is read back until the caller reads
    the result.
  * `generate_stream` — batch of one, one host read a token (the sampled
    id), stopping on EOS or budget; with ``sink_tokens`` the cache rolls in
    place when it fills (`cache.roll_kv_cache`) and the same graph replays
    on.

On the CPU the step runs eagerly and no graph is made. Kernel launches are
counted exactly: a capture counts none, each replay counts the launches it
holds (`ops._build.CountedGraph`).

``forward_fn(params, cache, tokens, start_pos) → (logits, cache)`` swaps the
model step (the JAX package's argument), e.g.
`parallel.tp_decode.tp_decode_forward_fn` or
`parallel.pipeline.make_pipeline_forward`'s. A forward that runs collectives
between its kernels (``collectives`` set on the function) runs its steps
eagerly on every backend. `generate`'s ``context_parallel_mesh`` prefills
the prompt with `parallel.context.context_parallel_prefill`; its decode
has no collective and is captured as usual.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache, roll_kv_cache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import Cache, Params, forward
from metalchat_tpu_torch.ops._build import CountedGraph, warm_up
from metalchat_tpu_torch.sampling import SamplerConfig, sample


@dataclass
class DecodeState:
    """Carry of the decode loop. A step updates these tensors in place, so
    a graph captured on them replays on them."""

    cache: Cache
    last_tokens: torch.Tensor        # int64 [B], sampled at the previous step
    pos: torch.Tensor                # int32 0-d, the cache fill length
    generator: torch.Generator       # the sampler's random draws
    done: torch.Tensor               # bool [B]


def _eos_hit(tokens: torch.Tensor, eos: Optional[torch.Tensor]) -> torch.Tensor:
    if eos is None:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    return (tokens[:, None] == eos[None, :]).any(dim=-1)


def _eos_tensor(eos_ids: Tuple[int, ...], device) -> Optional[torch.Tensor]:
    return torch.tensor(eos_ids, dtype=torch.int64, device=device) if eos_ids else None


def _model_step(config: ModelConfig, ffn_block: bool, forward_fn):
    """``forward_fn``, or `forward` with ``ffn_block``."""
    if forward_fn is not None:
        return forward_fn
    return lambda p, c, t, s: forward(p, c, t, s, config, ffn_block=ffn_block)


def make_prefill(config: ModelConfig, sampler: SamplerConfig, eos_ids: Tuple[int, ...] = (),
                 ffn_block: bool = False, forward_fn=None):
    """Returns ``prefill(params, cache, tokens, start_pos, generator) →
    DecodeState``: one `forward` over ``tokens [B, S]`` at the int
    ``start_pos`` (flash attention for S > 16), eagerly, and the first
    sampled token. ``ffn_block`` is `forward`'s, for prompts of at most 16
    tokens; ``forward_fn`` replaces `forward`."""
    fwd = _model_step(config, ffn_block, forward_fn)

    @torch.no_grad()
    def prefill(params: Params, cache: Cache, tokens: torch.Tensor, start_pos: int,
                generator: torch.Generator) -> DecodeState:
        logits, cache = fwd(params, cache, tokens, start_pos)
        return _first_state(cache, sample(logits[:, -1], generator, sampler),
                            start_pos + tokens.shape[1], generator, eos_ids)

    return prefill


def _first_state(cache: Cache, first: torch.Tensor, pos: int, generator: torch.Generator,
                 eos_ids: Tuple[int, ...]) -> DecodeState:
    """The decode carry after a prefill of ``pos`` positions whose sampled
    tokens are ``first [B]``."""
    eos = _eos_tensor(eos_ids, first.device)
    return DecodeState(cache=cache, last_tokens=first,
                       pos=torch.tensor(pos, dtype=torch.int32, device=first.device),
                       generator=generator, done=_eos_hit(first, eos))


class DecodeStep:
    """`make_decode_step`'s step. ``step(params, state) → (state, emitted)``
    emits the carried token, feeds it to the model at ``state.pos``, samples
    the next (held once a row is done) and advances ``pos``, all in place.

    On a CUDA state the first call runs the step eagerly (warm-up) and then
    captures one step into a CUDA graph; every later call on the same
    params, cache buffers and state tensors replays it. The graphs, and the
    tensors they read, are held by this object and dropped with it."""

    def __init__(self, config: ModelConfig, sampler: SamplerConfig,
                 eos_ids: Tuple[int, ...] = (), ffn_block: bool = False, forward_fn=None):
        self.config, self.sampler, self.ffn_block = config, sampler, ffn_block
        self.forward_fn = forward_fn
        self._fwd = _model_step(config, ffn_block, forward_fn)
        self.eos_ids = tuple(eos_ids)
        self._eos: Dict[torch.device, Optional[torch.Tensor]] = {}
        self._graphs: Dict[tuple, tuple] = {}

    def __call__(self, params: Params, state: DecodeState):
        emitted = self.advance(params, state)
        # A replay overwrites the graph's own output: hand out a copy.
        return state, emitted.clone() if emitted.is_cuda else emitted

    def _body(self, params: Params, state: DecodeState, eos, record) -> torch.Tensor:
        emitted = state.last_tokens.clone()
        if record is not None:
            out, base = record
            out.index_copy_(1, (state.pos.long() - base).reshape(1), emitted[:, None])
        logits, _ = self._fwd(params, state.cache, emitted[:, None], state.pos)
        nxt = sample(logits[:, -1], state.generator, self.sampler)
        hit = _eos_hit(nxt, eos)
        state.last_tokens.copy_(torch.where(state.done, emitted, nxt))
        state.done.logical_or_(hit)
        state.pos.add_(1)
        return emitted

    def _graph_route(self, device: torch.device) -> bool:
        """Whether steps on ``device`` are captured and replayed: on the
        card, unless ``forward_fn`` runs collectives between its kernels
        (the tensor-parallel forward: gloo's cannot be captured, and NCCL's
        capture is untested on a machine with one card), whose steps run
        eagerly on every backend. The CPU tests override it to drive the
        route with a stand-in graph."""
        return device.type == "cuda" and not getattr(self.forward_fn, "collectives", False)

    @property
    def captures(self) -> int:
        """The graphs this step has captured."""
        return len(self._graphs)

    @torch.no_grad()
    def advance(self, params: Params, state: DecodeState, record=None) -> torch.Tensor:
        """One step, in place; returns the emitted tokens ``[B]`` (on the
        card, the graph's own output, which the next replay overwrites).
        ``record = (out, base)`` also writes them into ``out[:, pos -
        base]`` inside the step (`generate`'s buffer)."""
        dev = state.last_tokens.device
        if dev not in self._eos:
            self._eos[dev] = _eos_tensor(self.eos_ids, dev)
        eos = self._eos[dev]
        if not self._graph_route(dev):
            return self._body(params, state, eos, record)
        held = [*(getattr(state.cache, f.name) for f in dataclasses.fields(state.cache)),
                state.last_tokens, state.pos, state.done]
        if record is not None:
            held.append(record[0])
        key = (id(params), id(state.generator), None if record is None else record[1],
               *((t.data_ptr(), tuple(t.shape)) for t in held))
        entry = self._graphs.get(key)
        if entry is not None:
            entry[0].replay()
            return entry[1]
        emitted = warm_up(lambda: self._body(params, state, eos, record), dev)
        graph = CountedGraph()
        graph.graph.register_generator_state(state.generator)
        static = graph.capture(lambda: self._body(params, state, eos, record))
        # Hold what the graph reads, so that no key's pointers are reused.
        self._graphs[key] = (graph, static, params, state.generator, held)
        return emitted


def make_decode_step(config: ModelConfig, sampler: SamplerConfig,
                     eos_ids: Tuple[int, ...] = (), ffn_block: bool = False,
                     forward_fn=None) -> DecodeStep:
    """Returns ``step(params, state) → (state, emitted [B])`` (`DecodeStep`):
    the JAX package's jitted step, as a CUDA graph on the card.
    ``ffn_block`` is `decode_step`'s; ``forward_fn`` replaces `forward`."""
    return DecodeStep(config, sampler, eos_ids, ffn_block, forward_fn)


def _default_cache(config: ModelConfig, params: Params, batch: int, limit: int,
                   quantized_kv: bool) -> Cache:
    device = params["final_norm"].device
    if quantized_kv:
        return QuantizedKVCache.create(config, batch, limit, device=device)
    return KVCache.create(config, batch, limit, dtype=params["final_norm"].dtype,
                          device=device)


@torch.no_grad()
def generate(params: Params, config: ModelConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, sampler: SamplerConfig = SamplerConfig.greedy(),
             eos_ids: Tuple[int, ...] = (), seed: int = 0,
             cache: Optional[Cache] = None, quantized_kv: bool = False,
             max_seq_len: Optional[int] = None, ffn_block: bool = False,
             forward_fn=None, context_parallel_mesh=None,
             context_parallel_axis: str = "sp") -> torch.Tensor:
    """Prompt ``[B, S]`` → generated ids ``[B, max_new_tokens]`` (int64).

    Same token semantics as the JAX package: the first token comes from the
    prefill logits; a row that hits an EOS id repeats it from then on. Runs
    on the device of the parameters: one prefill, then ``max_new_tokens -
    1`` decode steps, on the card one warm-up step and replays of one CUDA
    graph, with no host read in between. The default cache holds the
    prompt and the new tokens, dense in the activation dtype or int8.
    ``ffn_block`` merges each decode step's post-attention block into one
    kernel launch a layer (`decode_step`). ``forward_fn`` replaces
    `forward` (with it, pass the ``cache`` it expects: a tensor-parallel
    forward takes the rank's local cache). ``context_parallel_mesh`` (a
    `parallel.mesh.GridMesh` with the axis ``context_parallel_axis``) sends
    the prompt through `parallel.context.context_parallel_prefill`, every
    rank of the axis calling together (with the pipeline forward, over its
    stages' own layers); decode then runs on the rank's cache as without
    it."""
    device = params["final_norm"].device
    prompt = prompt.to(device)
    b, s = prompt.shape
    if cache is None:
        limit = max_seq_len or min(config.max_seq_len, s + max_new_tokens)
        cache = _default_cache(config, params, b, limit, quantized_kv)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if context_parallel_mesh is None:
        state = make_prefill(config, sampler, eos_ids, ffn_block, forward_fn)(
            params, cache, prompt, 0, generator)
    else:
        from metalchat_tpu_torch.parallel.context import context_parallel_prefill

        logits, cache = context_parallel_prefill(params, cache, prompt, config,
                                                 context_parallel_mesh, context_parallel_axis,
                                                 getattr(forward_fn, "stages", None))
        state = _first_state(cache, sample(logits, generator, sampler), s, generator, eos_ids)
    out = torch.empty((b, max_new_tokens), dtype=torch.int64, device=device)
    step = DecodeStep(config, sampler, eos_ids, ffn_block, forward_fn)
    for _ in range(max_new_tokens - 1):
        step.advance(params, state, record=(out, s))
    if max_new_tokens:
        out[:, max_new_tokens - 1] = state.last_tokens
    return out


@torch.no_grad()
def generate_stream(params: Params, config: ModelConfig, prompt: Sequence[int], *,
                    max_new_tokens: int, sampler: SamplerConfig = SamplerConfig(),
                    eos_ids: Tuple[int, ...] = (), seed: int = 0,
                    cache: Optional[Cache] = None, start_pos: int = 0,
                    max_seq_len: Optional[int] = None,
                    sink_tokens: Optional[int] = None, forward_fn=None) -> Iterator[int]:
    """Stream generated token ids one at a time (batch of one).

    Stops on EOS or token budget. Reuses a caller's cache (a multi-turn
    session keeps its KV warm) from ``start_pos``; the default cache is
    dense in the activation dtype. One host read a token: the sampled id.

    ``sink_tokens`` enables attention-sinks eviction: when the cache fills,
    the first ``sink_tokens`` positions stay and a quarter of the rest is
    evicted at once (`roll_kv_cache`, in place), so generation goes on past
    the cache length at degraded fidelity. Without it the stream stops
    there. ``forward_fn`` replaces `forward`."""
    device = params["final_norm"].device
    tokens = torch.tensor([list(prompt)], dtype=torch.int64, device=device)
    if cache is None:
        limit = max_seq_len or min(config.max_seq_len,
                                   len(prompt) + max_new_tokens + start_pos)
        cache = _default_cache(config, params, 1, limit, quantized_kv=False)
    cache_len = cache.max_seq_len
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = make_prefill(config, sampler, eos_ids, forward_fn=forward_fn)(
        params, cache, tokens, start_pos, generator)
    step = DecodeStep(config, sampler, eos_ids, forward_fn=forward_fn)
    pos = start_pos + len(prompt)  # the host's copy of state.pos
    for _ in range(max_new_tokens):
        token = int(state.last_tokens[0])
        yield token
        # A row is done exactly when its last sampled token is an EOS id.
        if token in eos_ids:
            return
        if pos + 1 >= cache_len:
            if sink_tokens is None:
                return  # context window exhausted
            shift = max(1, (cache_len - sink_tokens) // 4)
            roll_kv_cache(state.cache, sink_tokens, shift)
            state.pos.sub_(shift)
            pos -= shift
        step.advance(params, state)
        pos += 1
