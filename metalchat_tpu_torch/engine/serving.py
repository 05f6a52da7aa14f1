"""Continuous-batching serving engine (port of the JAX package's
``engine/serving.py``).

A slot-based scheduler that mixes prefill and decode on one card:

* the KV cache holds ``max_slots`` sequences: dense stripes (int8 or the
  activation dtype) or int8 pages shared through a page table (paged mode);
  each request is assigned a slot, prefilled in chunks, then joins the
  batched decode step;
* one decode step advances every slot with per-row positions and
  per-request sampler settings (`sampling.sample_batched`);
* a request that fails validation, or finds no KV pages, is completed with
  an error without touching the other slots;
* per-request metrics: TTFT (with and without queue wait) and tokens/s.

The JAX package compiles one program per model step. Here a "dispatch" is
one model call on the card: a prompt chunk for one or several slots, a
burst of decode steps, or both. The sampled tokens are read back once per
dispatch. A decode step runs on fixed device buffers of ``max_slots`` rows
(tokens, positions, ``advance``, the sampler settings, the output and a
step index), filled from one host staging buffer by one copy a dispatch and
updated in place by the step, so that on the card one captured CUDA graph
per sampling branch (`sampling.sampling_branch`) replays every step of
every burst: the JAX package's ``decode_step``, ``decode_burst_step`` (a
``lax.scan`` of that step) and the burst half of ``combined_step``. The
prompt chunks run eagerly. On the CPU the same step runs eagerly.
Every CUDA call of an engine happens on the thread that calls `step`.

``forward_fn`` swaps the model step (the pipeline's,
`parallel.pipeline.make_pipeline_forward`, with the rank's cache given as
``cache``: a dense one, int8 or in the activation dtype), ``cache``
supplies a dense cache, ``context_parallel_mesh`` prefills each prompt of
``context_parallel_threshold`` tokens or more whole through
`parallel.context.context_parallel_prefill` (dense cache modes; every rank
of the mesh runs the same loop; with the pipeline forward, over the
stages' own layers into the stage's cache), and ``spmd_mesh`` (a `parallel.mesh.Mesh`
of more than one rank) makes the engine one rank of a sharded group: it
takes the rank's local params (`parallel.mesh.shard_params`), builds its
local cache and routes every model call through
`parallel.tp_decode.spmd_forward_fn`'s forward (the tensor-parallel decode
where it takes the model, the sharded layer route for every other tree);
every rank runs the same loop (`parallel.multihost.MultiHostEngine`). A
forward with collectives between its kernels (``collectives`` set on the
function, as both sharded ones have) runs its bursts eagerly on every
backend.

Over the mesh's dp axis the engine keeps JAX's layout. A dense or int8
cache holds ``max_slots / dp`` slots on each dp row (slot s on row ``s //
(max_slots / dp)``, as `parallel.mesh.shard_cache` splits rows), at the
rank's kv-heads: a model call runs each dp row's own rows over its tp
group, and the f32 logits are gathered over dp, so that every rank samples
the whole batch with the same generator (JAX's replicated step outputs): a
decode step runs every row of the dp row, a prompt chunk only the rows the
dp row owns (a dp row with none runs no model and sends zeros, since a
gather needs equal shapes). A paged cache stays whole over dp, as JAX's
tensor-parallel decode keeps its pool and rows (a pool has no batch axis:
rows split over dp would let each dp row's pool diverge), so every dp row
runs every row and the dp axis needs no collective; `shard_cache`'s split
of the page table's rows over dp is the GSPMD layout of JAX's forward,
which the engine does not take.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.engine.paged import PageAllocator
from metalchat_tpu_torch.models.transformer import Cache, Params, forward
from metalchat_tpu_torch.ops._build import CountedGraph, warm_up
from metalchat_tpu_torch.sampling import SamplerConfig, sample_batched, sampling_branch
from metalchat_tpu_torch.utils.profiling import Meter, trace


@dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 128
    sampler: SamplerConfig = SamplerConfig.greedy()
    eos_ids: Tuple[int, ...] = ()
    request_id: Optional[int] = None


@dataclass
class Completion:
    request_id: int
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    error: Optional[str] = None
    # metrics
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def service_ttft(self) -> Optional[float]:
        """TTFT without the queue wait (admission → first token). Under
        all-upfront load, `ttft` is mostly queue time."""
        if self.first_token_at is None or self.admitted_at is None:
            return None
        return self.first_token_at - self.admitted_at

    @property
    def decode_tokens_per_sec(self) -> Optional[float]:
        if self.finished_at is None or self.first_token_at is None:
            return None
        dt = self.finished_at - self.first_token_at
        n = len(self.tokens) - 1
        return n / dt if dt > 0 and n > 0 else None


# The decode step's per-row settings, in this order, as [max_slots] rows of
# one flat int32 buffer (the float rows hold f32 bits), then the step index.
_BURST_ROWS = ("tokens", "positions", "advance", "top_k", "temperature", "top_p")
_FLOAT_ROWS = ("temperature", "top_p")


def _burst_rows(flat, rows: int, f32) -> Dict[str, object]:
    """Named views of ``flat`` (a numpy array or a tensor, int32): each of
    `_BURST_ROWS` ``[rows]``, the float rows reinterpreted as ``f32``, and
    ``step`` ``[1]``."""
    views = {name: flat[i * rows:(i + 1) * rows] for i, name in enumerate(_BURST_ROWS)}
    for name in _FLOAT_ROWS:
        views[name] = views[name].view(f32)
    views["step"] = flat[len(_BURST_ROWS) * rows:]
    return views


@dataclass
class _Slot:
    request: Request
    completion: Completion
    pos: int = 0                 # prefilled/generated length in the cache
    prefill_cursor: int = 0      # how much of the prompt is consumed
    last_token: int = 0          # token to feed at the next decode step
    decoding: bool = False
    pages: List[int] = field(default_factory=list)  # paged mode


class ContinuousBatchingEngine:
    def __init__(
        self,
        params: Params,
        config: ModelConfig,
        *,
        max_slots: int = 8,
        max_seq_len: Optional[int] = None,
        quantized_kv: bool = False,
        prefill_chunk: int = 256,
        cache_mode: str = "dense",        # "dense" | "paged"
        page_size: int = 256,
        num_pages: Optional[int] = None,
        seed: int = 0,
        decode_burst: int = 1,
        prefill_interleave: int = 4,
        ffn_block: bool = False,
        forward_fn=None,
        cache: Optional[Cache] = None,
        context_parallel_mesh=None,
        context_parallel_axis: str = "sp",
        context_parallel_threshold: int = 512,
        spmd_mesh=None,
    ):
        self.params = params
        self.config = config
        # The merged post-attention kernel on decode windows (`decode_step`).
        self.ffn_block = ffn_block
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or config.max_seq_len
        self.prefill_chunk = prefill_chunk
        # Decode burst: when the admission queue is drained, advance all
        # decoding slots up to `decode_burst` tokens per dispatch. Tokens a
        # row generates past its own EOS within a burst are dropped here.
        self.decode_burst = max(1, decode_burst)
        # Fairness: at most `prefill_interleave` consecutive prompt chunks
        # before decoding slots get a step.
        self.prefill_interleave = max(1, prefill_interleave)
        self._prefill_streak = 0
        self.paged = cache_mode == "paged"
        # Context-parallel prefill: a prompt of at least the threshold's tokens
        # is prefilled whole in one ring-attention pass over the mesh's axis
        # (`parallel.context.context_parallel_prefill`), every rank of the
        # axis running this engine in lockstep; dense cache modes only.
        self.cp_mesh = context_parallel_mesh
        self.cp_axis = context_parallel_axis
        self.cp_threshold = context_parallel_threshold
        if self.cp_mesh is not None and self.paged:
            raise ValueError("context-parallel prefill needs a dense cache mode")
        # The cache lives on the params' device.
        self.device = params["final_norm"].device
        # SPMD mode: this process is one rank of a sharded group; its cache
        # holds the rank's kv-heads and, split over dp, its dp row's slots
        # [lo, hi) (`_dp_rows`, None when every rank holds every slot).
        self.spmd_mesh = spmd_mesh if spmd_mesh is not None and spmd_mesh.size > 1 else None
        self._dp_rows: Optional[Tuple[int, int]] = None
        cache_config, cache_slots = config, max_slots
        if self.spmd_mesh is not None:
            from metalchat_tpu_torch.parallel.tp_decode import _local_config, spmd_forward_fn

            if forward_fn is None:
                forward_fn = spmd_forward_fn(params, config, self.spmd_mesh)
            cache_config = _local_config(config, self.spmd_mesh.tp)
            dp = self.spmd_mesh.dp
            if dp > 1 and not self.paged:
                if max_slots % dp:
                    raise ValueError(f"spmd_mesh: max_slots={max_slots} not divisible by "
                                     f"dp={dp}")
                if self.cp_mesh is not None:
                    raise ValueError("spmd_mesh: context-parallel prefill with slots split "
                                     "over dp is not supported")
                cache_slots = max_slots // dp
                lo = self.spmd_mesh.index("dp") * cache_slots
                self._dp_rows = (lo, lo + cache_slots)
        if cache is not None and self.paged:
            raise ValueError("an external cache is for the dense modes")
        if cache is not None:
            self.cache = cache
        elif self.paged:
            self.page_size = page_size
            mps = -(-self.max_seq_len // page_size)
            self.num_pages = num_pages or (max_slots * mps)
            self.allocator = PageAllocator(self.num_pages)
            self._sentinel = self.num_pages
            self._host_pt = np.full((max_slots, mps), self._sentinel, np.int32)
            self.cache = PagedKVCache.create(
                cache_config, num_pages=self.num_pages, page_size=page_size,
                max_slots=max_slots, max_pages_per_seq=mps, device=self.device)
            self._pt_dirty = True
        elif quantized_kv:
            self.cache = QuantizedKVCache.create(cache_config, cache_slots, self.max_seq_len,
                                                 device=self.device)
        else:
            # KV dtype follows the activation dtype (params' final norm).
            self.cache = KVCache.create(cache_config, cache_slots, self.max_seq_len,
                                        dtype=params["final_norm"].dtype, device=self.device)
        # forward_fn(params, cache, tokens, start_pos) -> (logits, cache), or
        # None for `forward` with this engine's ffn_block.
        self.forward_fn = forward_fn
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # The decode step's buffers (`_burst_step`), allocated once: the
        # host fills `_staging` (pinned on the card, so the copy is
        # asynchronous: it is written again only after the dispatch's
        # read-back), one copy a dispatch moves it into `_io`.
        size = len(_BURST_ROWS) * max_slots + 1
        self._staging = torch.zeros(size, dtype=torch.int32,
                                    pin_memory=self.device.type == "cuda")
        self._host = _burst_rows(self._staging.numpy(), max_slots, np.float32)
        self._io = torch.zeros(size, dtype=torch.int32, device=self.device)
        self._rows = _burst_rows(self._io, max_slots, torch.float32)
        self._out = torch.zeros((self.decode_burst, max_slots), dtype=torch.int64,
                                device=self.device)
        # One captured step per sampling branch (at most three), in one pool.
        self._graphs: Dict[str, CountedGraph] = {}
        self._pool = None
        self._queue: Deque[Request] = deque()
        self._slots: Dict[int, _Slot] = {}
        self._free: List[int] = list(range(max_slots))
        self._ids = itertools.count()
        self._completions: Dict[int, Completion] = {}
        self.meter = Meter()
        self.meter.start()
        # One dispatch is one model call with one read-back of its tokens:
        # the host cost per dispatch sets the pace of serving.
        self.counters = {"prefill_dispatches": 0, "decode_dispatches": 0,
                         "combined_dispatches": 0,
                         "decode_steps": 0, "decode_row_steps": 0}
        # Prompt-chunk model calls by token shape (B, S): windows of at most
        # 16 tokens take the decode path, longer ones the prefill path, so
        # the shapes say which kernels each call launched.
        self.prefill_shapes: Counter = Counter()
        # Whole-prompt context-parallel prefills by token shape (no flash).
        self.cp_prefill_shapes: Counter = Counter()

    # -- public API --------------------------------------------------------

    def submit(self, request: Request) -> int:
        rid = request.request_id if request.request_id is not None else next(self._ids)
        request.request_id = rid
        completion = Completion(request_id=rid, submitted_at=time.perf_counter())
        self._completions[rid] = completion
        if not request.prompt:
            completion.finished = True
            completion.error = "empty prompt"
            completion.finish_reason = "error"
            return rid
        if len(request.prompt) + request.max_new_tokens > self.max_seq_len:
            completion.finished = True
            completion.error = (
                f"prompt+max_new_tokens exceeds max_seq_len={self.max_seq_len}"
            )
            completion.finish_reason = "error"
            return rid
        self._queue.append(request)
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._slots)

    def step(self) -> List[Tuple[int, int]]:
        """Advance the engine one scheduling step.

        Prefill gets priority (keeps TTFT bounded) but never starves decode:
        after `prefill_interleave` consecutive prompt chunks, the decoding
        slots get a turn even while prompts are still arriving, and the
        pending prompts' next chunk rides in the same dispatch. Returns
        newly emitted (request_id, token) pairs.
        """
        if self._queue and self._free:
            if self._admit(self._queue[0]):
                self._queue.popleft()
                return []
            if not self._slots:
                # Nothing running to free pages: the request can never fit.
                request = self._queue.popleft()
                completion = self._completions[request.request_id]
                completion.finished = True
                completion.error = "insufficient KV pages for prompt"
                completion.finish_reason = "kv_oom"
                return []
        any_decoding = any(s.decoding for s in self._slots.values())
        pending = [(i, s) for i, s in self._slots.items() if not s.decoding]
        if pending and (not any_decoding
                        or self._prefill_streak < self.prefill_interleave):
            self._prefill_streak += 1
            batch = self._prefill_batch_candidates(pending)
            if len(batch) > 1:
                return self._prefill_batch(batch)
            if self._wants_cp(pending[0][1]):
                return self._cp_prefill(pending[0][0])
            return self._prefill_batch([pending[0][0]])
        self._prefill_streak = 0
        if any_decoding:
            if pending:
                batch = self._prefill_batch_candidates(pending, min_k=1)
                if batch:
                    return self._combined(batch)
            return self._decode_all()
        return []

    def run(self, requests: Sequence[Request]) -> Dict[int, Completion]:
        ids = [self.submit(r) for r in requests]
        while self.has_work:
            self.step()
        return {rid: self._completions[rid] for rid in ids}

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics (tokens/s, TTFT p50/p99) and counters."""
        self.meter.stop()
        out = self.meter.summary()
        self.meter.start()
        out.update(self.counters)
        return out

    def completion(self, request_id: int) -> Completion:
        return self._completions[request_id]

    def cancel(self, request_id: int, reason: str = "cancelled") -> bool:
        """Abort a request (client disconnect / timeout): drop it from the
        queue or release its slot so other requests keep their capacity.
        Returns False if unknown or already finished."""
        completion = self._completions.get(request_id)
        if completion is None or completion.finished:
            return False
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]
                break
        else:
            for slot_id, slot in list(self._slots.items()):
                if slot.request.request_id == request_id:
                    self._release(slot_id)
                    break
        self._finish(completion, reason)
        return True

    # -- model calls -------------------------------------------------------

    def _forward(self, cache, tokens: torch.Tensor, start_pos) -> torch.Tensor:
        """One model call → f32 logits ``[B, S, V]``; the cache is updated
        in place."""
        if self.forward_fn is not None:
            return self.forward_fn(self.params, cache, tokens, start_pos)[0]
        return forward(self.params, cache, tokens, start_pos, self.config,
                       ffn_block=self.ffn_block)[0]

    def _flush_page_table(self) -> None:
        """Upload the page table at most once per model call."""
        if self.paged and self._pt_dirty:
            self.cache.page_table.copy_(torch.from_numpy(self._host_pt))
            self._pt_dirty = False

    @torch.no_grad()
    def _run_prefill(self, slot_ids: List[int], toks, starts, lasts) -> torch.Tensor:
        """One padded prompt chunk for each slot in ONE model call; returns
        the logits at each row's last real position, ``[k, V]`` on the card.
        With slots split over dp each dp row runs the slots it owns and the
        logits are gathered over dp (the module docstring)."""
        if self._dp_rows is None:
            return self._prefill_rows(slot_ids, toks, starts, lasts)
        lo, hi = self._dp_rows
        owner = [s // (hi - lo) for s in slot_ids]
        mine = [i for i, s in enumerate(slot_ids) if lo <= s < hi]
        width = max(Counter(owner).values())
        part = torch.zeros((width, self.config.vocab_size), dtype=torch.float32,
                           device=self.device)
        if mine:
            part[:len(mine)] = self._prefill_rows(
                [slot_ids[i] - lo for i in mine], [toks[i] for i in mine],
                [starts[i] for i in mine], [lasts[i] for i in mine])
        whole = self.spmd_mesh.all_gather(part, dim=0, axis="dp")
        place = [owner[i] * width + owner[:i].count(owner[i]) for i in range(len(slot_ids))]
        return whole[torch.tensor(place, device=self.device)]

    def _prefill_rows(self, slot_ids: List[int], toks, starts, lasts) -> torch.Tensor:
        """`_run_prefill` on this rank's cache rows ``slot_ids``. One slot
        writes at an int offset, several at per-row offsets."""
        dev = self.device
        rows = torch.tensor(slot_ids, device=dev)
        tokens = torch.tensor(toks, dtype=torch.long, device=dev)
        start = starts[0] if len(slot_ids) == 1 else torch.tensor(
            starts, dtype=torch.int32, device=dev)
        self.prefill_shapes[tuple(tokens.shape)] += 1
        with trace("prefill"):
            if self.paged:
                # Pages are shared: only the slots' table rows take part.
                sub = dataclasses.replace(self.cache, page_table=self.cache.page_table[rows])
                logits = self._forward(sub, tokens, start)
            else:
                # The slots' stripes, gathered and written back.
                names = [f.name for f in dataclasses.fields(self.cache)]
                sub = type(self.cache)(**{n: getattr(self.cache, n)[:, rows] for n in names})
                logits = self._forward(sub, tokens, start)
                for n in names:
                    getattr(self.cache, n)[:, rows] = getattr(sub, n)
        return logits[torch.arange(len(slot_ids), device=dev),
                      torch.tensor(lasts, device=dev)]

    def _burst_step(self, branch: str) -> None:
        """One decode step for all rows, in place on the buffers: the model
        at each row's position, the sampler with `branch`, the token into
        ``out[step]``, then ``step += 1``, ``positions += advance`` and the
        tokens overwritten. It reads nothing back, so a CUDA graph captures
        it."""
        r = self._rows
        tokens, positions = r["tokens"], r["positions"]
        if self._dp_rows is not None:  # this dp row's rows, then every row's logits
            lo, hi = self._dp_rows
            tokens, positions = tokens[lo:hi], positions[lo:hi]
        logits = self._forward(self.cache, tokens[:, None], positions)
        if self._dp_rows is not None:
            logits = self.spmd_mesh.all_gather(logits, dim=0, axis="dp")
        nxt = sample_batched(logits[:, 0], self._gen, r["temperature"], r["top_k"],
                             r["top_p"], branch)
        self._out.index_copy_(0, r["step"].long(), nxt[None])
        r["step"].add_(1)
        r["positions"].add_(r["advance"])
        r["tokens"].copy_(nxt)

    def _graph_route(self) -> bool:
        """Whether bursts replay captured steps: on the card, unless the
        step runs collectives (a sharded forward, or the gather over dp:
        gloo's cannot be captured, and NCCL's capture is untested on a
        machine with one card), whose bursts run eagerly on every backend."""
        return (self.device.type == "cuda" and self._dp_rows is None
                and not getattr(self.forward_fn, "collectives", False))

    def _new_graph(self) -> CountedGraph:
        """An empty graph for one burst step in the engine's memory pool,
        the sampler's generator registered, so that draws after a replay
        continue the generator's state."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = CountedGraph(pool=self._pool)
        graph.graph.register_generator_state(self._gen)
        return graph

    @torch.no_grad()
    def _run_burst(self, steps: int, branch: str) -> torch.Tensor:
        """`steps` decode steps for all rows from the staged rows → tokens
        ``[steps, B]`` on the card (rows of the output buffer, which the
        next dispatch overwrites). Inactive rows ride along pinned at their
        position (`advance` 0): their writes land at a position every future
        reader's own prefill re-writes first.

        On the card the first burst of a sampling branch runs one step
        eagerly (the warm-up; its token counts) and captures the step; every
        other step is a replay of that graph."""
        if steps > self._out.shape[0]:
            raise ValueError(f"a burst of {steps} steps exceeds the output buffer's "
                             f"{self._out.shape[0]} (decode_burst at construction)")
        self._io.copy_(self._staging, non_blocking=True)
        todo = steps
        with trace("decode burst"):
            graph = self._graphs.get(branch)
            if graph is None and self._graph_route():
                warm_up(lambda: self._burst_step(branch), self.device)
                graph = self._graphs[branch] = self._new_graph()
                graph.capture(lambda: self._burst_step(branch))
                todo -= 1
            for _ in range(todo):
                if graph is None:
                    self._burst_step(branch)
                else:
                    graph.replay()
        return self._out[:steps]

    # -- internals ---------------------------------------------------------

    def _admit(self, request: Request) -> bool:
        """Assign a slot (and, in paged mode, the prompt's pages plus one).
        Returns False when KV pages are exhausted: the request stays queued
        until running requests complete and free pages."""
        slot_id = self._free[-1]
        slot = _Slot(request=request, completion=self._completions[request.request_id])
        if self.paged:
            needed = -(-len(request.prompt) // self.page_size) + 1
            if not self.allocator.can_allocate(needed):
                return False
            slot.pages = self.allocator.allocate(slot_id, needed)
            self._host_pt[slot_id, : len(slot.pages)] = slot.pages
            self._pt_dirty = True
        self._free.pop()
        self._slots[slot_id] = slot
        slot.completion.admitted_at = time.perf_counter()
        return True

    def _grow_slot(self, slot_id: int, slot: _Slot) -> bool:
        """Ensure a physical page exists for slot.pos (decode growth)."""
        needed = slot.pos // self.page_size + 1
        if needed <= len(slot.pages):
            return True
        if not self.allocator.can_allocate(1):
            return False
        page = self.allocator.allocate(slot_id, 1)[0]
        slot.pages.append(page)
        self._host_pt[slot_id, len(slot.pages) - 1] = page
        self._pt_dirty = True
        return True

    def _bucket_chunk(self, chunk: List[int], slot: _Slot) -> List[int]:
        """End-pad a short (final) prompt chunk to a power-of-two bucket
        (≥ 32), as the JAX package does to bound its compiled programs; the
        pad lands at positions ≥ the prompt length, hidden by causal masks
        and per-row lengths and overwritten by decode. The bucket is clamped
        to the slot's write room (cache tail / allocated pages) so padded KV
        writes never reach past the slot's own rows or pages."""
        n = len(chunk)
        if n >= self.prefill_chunk:
            return chunk
        bucket = 32
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.prefill_chunk)
        if self.paged:
            room = len(slot.pages) * self.page_size - slot.pos
        else:
            room = self.max_seq_len - slot.pos
        bucket = max(n, min(bucket, room))
        return chunk + [0] * (bucket - n)

    def _next_chunk(self, slot: _Slot) -> Tuple[List[int], List[int]]:
        """(chunk, padded_chunk) a slot's next prefill dispatch would run."""
        prompt = list(slot.request.prompt)
        chunk = prompt[slot.prefill_cursor : slot.prefill_cursor + self.prefill_chunk]
        return chunk, self._bucket_chunk(chunk, slot)

    def _wants_cp(self, slot: _Slot) -> bool:
        return (self.cp_mesh is not None and slot.prefill_cursor == 0
                and len(slot.request.prompt) >= self.cp_threshold)

    def _prefill_batch_candidates(self, pending, min_k: int = 2) -> List[int]:
        """Largest group of pending slots whose next chunks share one padded
        length (k capped at 8 and rounded down to a power of two). min_k=1
        admits single-slot groups (the combined dispatch wants any prefill
        work it can fold in). A slot whose prompt rides the context-parallel
        prefill joins no group."""
        groups: Dict[int, List[int]] = {}
        for slot_id, slot in pending:
            if self._wants_cp(slot):
                continue
            _, padded = self._next_chunk(slot)
            groups.setdefault(len(padded), []).append(slot_id)
        if not groups:
            return []
        best = max(groups.values(), key=len)
        k = 1
        while k * 2 <= min(len(best), 8):
            k *= 2
        return best[:k] if k >= min_k else []

    def _prefill_args(self, slot_ids: List[int]):
        """(tokens, starts, lasts, chunk_lens) for one chunk per slot."""
        toks, starts, lasts, chunk_lens = [], [], [], []
        for sid in slot_ids:
            slot = self._slots[sid]
            chunk, padded = self._next_chunk(slot)
            toks.append(padded)
            starts.append(slot.pos)
            lasts.append(len(chunk) - 1)
            chunk_lens.append(len(chunk))
        return toks, starts, lasts, chunk_lens

    def _sample_first(self, slot_ids: List[int], chunk_lens: List[int],
                      logits: torch.Tensor) -> Optional[torch.Tensor]:
        """First tokens ``[k]`` (on the card) for the rows whose prompt
        completes with this chunk, each with its request's sampler; None
        when no prompt completes. Other rows' samples are discarded."""
        temps = np.zeros(len(slot_ids), np.float32)
        ks = np.zeros(len(slot_ids), np.int32)
        ps = np.ones(len(slot_ids), np.float32)
        done = False
        for row, sid in enumerate(slot_ids):
            slot = self._slots[sid]
            if slot.prefill_cursor + chunk_lens[row] >= len(slot.request.prompt):
                cfg = slot.request.sampler
                temps[row], ks[row], ps[row] = cfg.temperature, cfg.top_k, cfg.top_p
                done = True
        return sample_batched(logits, self._gen, temps, ks, ps) if done else None

    def _prefill_batch(self, slot_ids: List[int]) -> List[Tuple[int, int]]:
        """Run one prompt chunk for every slot in `slot_ids` in ONE dispatch."""
        self.counters["prefill_dispatches"] += 1
        self._flush_page_table()
        toks, starts, lasts, chunk_lens = self._prefill_args(slot_ids)
        logits = self._run_prefill(slot_ids, toks, starts, lasts)
        first = self._sample_first(slot_ids, chunk_lens, logits)
        return self._apply_prefill(slot_ids, chunk_lens,
                                   None if first is None else first.tolist())

    @torch.no_grad()
    def _cp_prefill(self, slot_id: int) -> List[Tuple[int, int]]:
        """The slot's whole prompt in one context-parallel prefill, written
        into its stripe of the cache (views: in place); its first token.
        Under the pipeline forward (its ``stages``) the cache is the stage's
        and the prefill runs over the stages' own layers."""
        from metalchat_tpu_torch.parallel.context import context_parallel_prefill

        self.counters["prefill_dispatches"] += 1
        prompt = list(self._slots[slot_id].request.prompt)
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        self.cp_prefill_shapes[tuple(tokens.shape)] += 1
        sub = type(self.cache)(**{f.name: getattr(self.cache, f.name)[:, slot_id:slot_id + 1]
                                  for f in dataclasses.fields(self.cache)})
        with trace("cp prefill"):
            logits, _ = context_parallel_prefill(self.params, sub, tokens, self.config,
                                                 self.cp_mesh, self.cp_axis,
                                                 getattr(self.forward_fn, "stages", None))
        first = self._sample_first([slot_id], [len(prompt)], logits)
        return self._apply_prefill([slot_id], [len(prompt)], first.tolist())

    def _apply_prefill(self, slot_ids: List[int], chunk_lens: List[int],
                       first: Optional[List[int]]) -> List[Tuple[int, int]]:
        """Advance prefill cursors; emit the first tokens of slots whose
        prompt completed with this chunk."""
        emitted: List[Tuple[int, int]] = []
        for row, sid in enumerate(slot_ids):
            slot = self._slots[sid]
            slot.pos += chunk_lens[row]
            slot.prefill_cursor += chunk_lens[row]
            if slot.prefill_cursor >= len(slot.request.prompt):
                slot.decoding = True
                slot.last_token = first[row]
                emitted.extend(self._emit(sid, slot, first[row]))
        return emitted

    def _decode_args(self, frontier: Optional[Dict[int, int]] = None):
        """Stage the batched decode step's rows; returns the active slots
        and the sampling branch of their settings.

        Rows not decoding still run through the batched step and write one
        garbage KV row. Free rows sit at position 0 (re-written by the next
        occupant's first prefill chunk before any read); rows that are
        MID-PREFILL sit at their prefill frontier (re-written by their own
        next chunk before that chunk attends): position 0 would corrupt
        prompt KV they already wrote. `frontier` overrides those rows'
        positions (the combined dispatch pins them at their POST-chunk
        frontier, since its prefill part advances them first)."""
        h = self._host
        self._staging.zero_()  # tokens, positions, advance, top-k, temperature, step
        h["top_p"][:] = 1.0
        for slot_id, slot in self._slots.items():
            if not slot.decoding:
                h["positions"][slot_id] = slot.pos
        if frontier:
            for slot_id, pos in frontier.items():
                h["positions"][slot_id] = pos
        active = []
        for slot_id, slot in list(self._slots.items()):
            if not slot.decoding:
                continue
            if self.paged and not self._grow_slot(slot_id, slot):
                self._finish(slot.completion, "kv_oom")
                self._release(slot_id)
                continue
            active.append(slot_id)
            h["tokens"][slot_id] = slot.last_token
            h["positions"][slot_id] = slot.pos
            h["advance"][slot_id] = 1
            h["temperature"][slot_id] = slot.request.sampler.temperature
            h["top_k"][slot_id] = slot.request.sampler.top_k
            h["top_p"][slot_id] = slot.request.sampler.top_p
        return active, sampling_branch(h["temperature"], h["top_k"], h["top_p"])

    def _apply_burst(self, toks: np.ndarray,
                     active: List[int]) -> List[Tuple[int, int]]:
        emitted: List[Tuple[int, int]] = []
        for k in range(toks.shape[0]):
            for slot_id in active:
                slot = self._slots.get(slot_id)
                if slot is None:  # finished (EOS/limit) at an earlier burst step
                    continue
                slot.pos += 1
                token = int(toks[k, slot_id])
                slot.last_token = token
                emitted.extend(self._emit(slot_id, slot, token))
        return emitted

    def _decode_all(self) -> List[Tuple[int, int]]:
        active, branch = self._decode_args()
        if not active:
            return []
        steps = self._burst_steps(active)
        self.counters["decode_dispatches"] += 1
        self.counters["decode_steps"] += steps
        self.counters["decode_row_steps"] += steps * len(active)
        self._flush_page_table()
        burst = self._run_burst(steps, branch)
        return self._apply_burst(burst.cpu().numpy(), active)

    def _combined(self, prefill_ids: List[int]) -> List[Tuple[int, int]]:
        """One prompt chunk for `prefill_ids` + a decode burst for the
        decoding slots in ONE dispatch, with one read-back. The burst pins
        the just-prefilled rows at their POST-chunk frontier (advance 0), so
        the ride-along invariant is unchanged."""
        p_toks, p_starts, p_lasts, chunk_lens = self._prefill_args(prefill_ids)
        frontier = {sid: self._slots[sid].pos + chunk_lens[row]
                    for row, sid in enumerate(prefill_ids)}
        active, branch = self._decode_args(frontier)
        if not active:
            # Decoders all finished during arg building (paged kv_oom).
            return self._prefill_batch(prefill_ids)
        steps = self._burst_steps(active)
        self.counters["combined_dispatches"] += 1
        self.counters["decode_steps"] += steps
        self.counters["decode_row_steps"] += steps * len(active)
        self._flush_page_table()
        logits = self._run_prefill(prefill_ids, p_toks, p_starts, p_lasts)
        first = self._sample_first(prefill_ids, chunk_lens, logits)
        burst = self._run_burst(steps, branch)
        if first is None:
            toks, first_host = burst.cpu().numpy(), None
        else:  # one read-back for the first tokens and the burst
            flat = torch.cat([burst.reshape(-1), first]).cpu().numpy()
            toks = flat[:burst.numel()].reshape(burst.shape)
            first_host = flat[burst.numel():].tolist()
        emitted = self._apply_prefill(prefill_ids, chunk_lens, first_host)
        return emitted + self._apply_burst(toks, active)

    def _burst_steps(self, active: List[int]) -> int:
        """How many decode steps to run in one dispatch.

        Bounded by cache room (no out-of-range writes), by the largest
        remaining generation budget of the rows, and, in paged mode, by the
        pages that can be pre-allocated; rounded down to a power of two as
        in the JAX package. A row at its budget finishes mid-burst like an
        EOS row: the host drops its surplus tokens, and its surplus KV
        writes stay inside its own slot, masked by per-row lengths."""
        limit = self.decode_burst
        if limit <= 1:
            return 1
        for slot_id in active:
            slot = self._slots[slot_id]
            limit = min(limit, self.max_seq_len - slot.pos)
        max_budget = max(
            self._slots[s].request.max_new_tokens
            - len(self._slots[s].completion.tokens)
            for s in active
        )
        limit = min(limit, max_budget)
        if self.paged:
            mps = self._host_pt.shape[1]
            for slot_id in active:
                slot = self._slots[slot_id]
                covered = len(slot.pages) * self.page_size - slot.pos
                while (covered < limit and len(slot.pages) < mps
                       and self.allocator.can_allocate(1)):
                    page = self.allocator.allocate(slot_id, 1)[0]
                    slot.pages.append(page)
                    self._host_pt[slot_id, len(slot.pages) - 1] = page
                    self._pt_dirty = True
                    covered += self.page_size
                limit = min(limit, covered)
        steps = 1
        while steps * 2 <= limit:
            steps *= 2
        return steps

    def _finish(self, completion: Completion, reason: str) -> None:
        """Mark finished and record metering for ANY completion that produced
        a first token, cancelled and kv_oom ones included, so the TTFT
        percentiles have no survivorship bias under load shedding."""
        completion.finished = True
        completion.finished_at = time.perf_counter()
        completion.finish_reason = reason
        if completion.first_token_at is not None:
            self.meter.record_request(completion.ttft, len(completion.tokens),
                                      completion.service_ttft)

    def _emit(self, slot_id: int, slot: _Slot, token: int) -> List[Tuple[int, int]]:
        completion = slot.completion
        now = time.perf_counter()
        if completion.first_token_at is None:
            completion.first_token_at = now
        completion.tokens.append(token)
        done_eos = token in slot.request.eos_ids
        done_len = len(completion.tokens) >= slot.request.max_new_tokens
        if done_eos or done_len or slot.pos + 1 >= self.max_seq_len:
            self._finish(completion, "eos" if done_eos
                         else ("length" if done_len else "cache_full"))
            self._release(slot_id)
        return [(slot.request.request_id, token)]

    def _release(self, slot_id: int) -> None:
        del self._slots[slot_id]
        self._free.append(slot_id)
        if self.paged:
            self.allocator.free_slot(slot_id)
            self._host_pt[slot_id, :] = self._sentinel
            self._pt_dirty = True
