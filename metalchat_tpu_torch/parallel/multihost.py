"""Multi-process serving in lockstep (port of the JAX package's
``parallel/multihost.py``: ``MultiHostServer``, ``MultiHostEngine`` and
``MultiHostRoundError``).

`MultiHostServer` is the batch-synchronous server over a (dp, tp) mesh
(`parallel.distributed.make_hybrid_mesh`): rank 0 owns the queue and groups
the requests into rounds of one prompt length, every rank receives each
round's tokens, each dp row generates its share of the round's rows over
its tp group on the sharded layer route (JAX's ``generate`` on sharded
params), and the ids are gathered over dp.

`MultiHostEngine` builds the same engine on every rank, on its shard of the
weights, and runs the same scheduling loop. The engine's host state is a
function of the request intake and of the sampled tokens, and the sampled
tokens are the same on every rank (the logits are gathered whole on every
rank, the sampler's generator is seeded alike), so the only traffic besides
the model's collectives is rank 0 broadcasting the request list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import Mesh, shard_cache, shard_params
from metalchat_tpu_torch.sampling import SamplerConfig


class MultiHostRoundError(RuntimeError):
    """A serving round failed; carries what is needed to resume: the
    completed token lists and the indices (into the original request list)
    of the requests still to serve, the failed round's included."""

    def __init__(self, round_index: int, pending_indices: List[int],
                 completed: List[List[int]]):
        super().__init__(f"multi-host serving round {round_index} failed; "
                         f"{len(pending_indices)} requests pending re-queue")
        self.round_index = round_index
        self.pending_indices = pending_indices
        self.completed = completed


@dataclass
class MultiHostServer:
    """Rank-0-routed batch server over a sharded tree.

    Every rank constructs it with the same arguments: ``params`` is the
    whole tree (every rank makes or loads the same one), sharded here to the
    rank's local tree (the whole one may then be freed). ``batch_size`` is a
    round's global batch, a multiple of ``mesh.dp``: each dp row runs its
    ``batch_size / dp`` rows. Only rank 0's ``requests`` matter."""

    params: dict
    config: ModelConfig
    mesh: Mesh
    batch_size: int = 4
    max_new_tokens: int = 32
    quantized_kv: bool = False
    sampler: SamplerConfig = SamplerConfig.greedy()

    def __post_init__(self):
        if self.batch_size % self.mesh.dp:
            raise ValueError(f"batch_size={self.batch_size} not divisible by "
                             f"dp={self.mesh.dp}")
        self.params = shard_params(self.params, self.config, self.mesh)

    def _cache(self, prompt_len: int):
        """This rank's cache of the round: its dp row's batch rows, its
        kv-heads."""
        cls = QuantizedKVCache if self.quantized_kv else KVCache
        limit = min(self.config.max_seq_len, prompt_len + self.max_new_tokens)
        kw = {} if self.quantized_kv else {"dtype": self.params["final_norm"].dtype}
        return shard_cache(cls.create(self.config, self.batch_size, limit,
                                      device=self.params["final_norm"].device, **kw),
                           self.mesh)

    def serve(self, requests: Optional[Sequence[Sequence[int]]]) -> List[List[int]]:
        """Run all requests; returns rank 0's token list a request (other
        ranks return an empty list).

        Rounds group requests of one prompt length (the single device's
        tokens: no pad conditioning); a short round repeats a real row and
        drops the copies. A failed round raises `MultiHostRoundError` with
        the completed lists and the indices of the requests still to
        serve."""
        mesh = self.mesh
        is_root = mesh.rank == 0
        rounds: List[Tuple[int, List[Tuple[int, List[int]]]]] = []
        n_requests = 0
        if is_root and requests:
            n_requests = len(requests)
            by_len: dict = {}
            for i, p in enumerate(requests):
                by_len.setdefault(len(p), []).append((i, [int(t) for t in p]))
            for length in sorted(by_len):
                group = by_len[length]
                for c in range(0, len(group), self.batch_size):
                    rounds.append((length, group[c:c + self.batch_size]))
        n_rounds = mesh.broadcast_object(len(rounds))

        results: List[List[int]] = [[] for _ in range(n_requests)]
        for r in range(n_rounds):
            toks = None
            if is_root:
                length, batch = rounds[r]
                toks = np.zeros((self.batch_size, length), np.int64)
                for j in range(self.batch_size):
                    toks[j] = batch[min(j, len(batch) - 1)][1]
            toks = mesh.broadcast_object(toks)  # the round's length and tokens
            try:
                out = self._round(toks, toks.shape[1])
            except Exception as exc:  # noqa: BLE001 — the containment boundary
                # A failed round (a lost peer surfaces as a collective error)
                # keeps the work already done and names the requests to serve
                # again, the failed round's included, on a rebuilt group.
                pending = [idx for _, grp in rounds[r:] for idx, _ in grp]
                raise MultiHostRoundError(r, pending, results) from exc
            if is_root:
                for j, (idx, _) in enumerate(rounds[r][1]):
                    results[idx] = out[j].tolist()
        return results

    def _round(self, toks: np.ndarray, length: int) -> torch.Tensor:
        """The round's ids ``[batch_size, max_new_tokens]`` on every rank:
        this dp row's rows through `generate` on the sharded layer route,
        then gathered over dp."""
        from metalchat_tpu_torch.engine.generate import generate
        from metalchat_tpu_torch.parallel.tp_decode import layer_route_forward_fn

        rows = self.batch_size // self.mesh.dp
        lo = self.mesh.index("dp") * rows
        device = self.params["final_norm"].device
        out = generate(self.params, self.config, torch.from_numpy(toks[lo:lo + rows]).to(device),
                       max_new_tokens=self.max_new_tokens, sampler=self.sampler,
                       cache=self._cache(length),
                       forward_fn=layer_route_forward_fn(self.config, self.mesh))
        return self.mesh.all_gather(out.cpu(), dim=0, axis="dp")


def broadcast_requests(mesh, requests: Optional[Sequence]) -> List:
    """Rank 0's ``requests`` (`engine.serving.Request`; other ranks pass
    None), rebuilt on every rank of ``mesh`` (a `Mesh` or `GridMesh`) from
    one broadcast of their prompts, budgets, EOS ids and sampler settings."""
    from metalchat_tpu_torch.engine.serving import Request

    spec = None
    if mesh.rank == 0:
        spec = [{"prompt": [int(t) for t in r.prompt],
                 "max_new_tokens": r.max_new_tokens,
                 "eos_ids": [int(t) for t in r.eos_ids],
                 "sampler": [r.sampler.temperature, r.sampler.top_k, r.sampler.top_p]}
                for r in (requests or [])]
    spec = mesh.broadcast_object(spec)
    return [Request(prompt=s["prompt"], max_new_tokens=s["max_new_tokens"],
                    eos_ids=tuple(s["eos_ids"]),
                    sampler=SamplerConfig(temperature=s["sampler"][0],
                                          top_k=int(s["sampler"][1]), top_p=s["sampler"][2]))
            for s in spec]


class MultiHostEngine:
    """Continuous batching over a tensor-parallel group, one process a rank.

    Every rank constructs it with the same arguments: ``params`` is the
    whole tree (every rank makes or loads the same one), sharded here to the
    rank's local tree (the whole one may then be freed), and the engine
    (`engine.serving.ContinuousBatchingEngine`, ``spmd_mesh=mesh``) builds
    its local cache and runs the tensor-parallel forward. ``engine_kw`` goes
    to the engine."""

    def __init__(self, params, config: ModelConfig, mesh: Mesh, **engine_kw):
        from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine

        self.mesh = mesh
        self.is_root = mesh.rank == 0
        self.engine = ContinuousBatchingEngine(shard_params(params, config, mesh), config,
                                               spmd_mesh=mesh, **engine_kw)

    def run(self, requests: Optional[Sequence] = None) -> Dict[int, object]:
        """Serve rank 0's ``requests`` (other ranks pass None): {request_id:
        Completion}, the same token streams on every rank. A step that
        raises ends the run with `MultiHostRoundError` (round 0: the whole
        list is one round)."""
        reqs = broadcast_requests(self.mesh, requests if self.is_root else None)
        # The same submissions, deterministic scheduling and the same
        # sampled tokens give the same step() sequence on every rank.
        engine = self.engine
        ids = [engine.submit(r) for r in reqs]
        try:
            while engine.has_work:
                engine.step()
        except Exception as exc:  # noqa: BLE001 — the containment boundary
            # A failed step (a lost peer surfaces as a collective error) keeps
            # the finished streams and names the requests to serve again on
            # a rebuilt group.
            done = [engine.completion(rid) for rid in ids]
            raise MultiHostRoundError(
                0, [i for i, c in enumerate(done) if not c.finished],
                [c.tokens if c.finished else [] for c in done]) from exc
        return {rid: engine.completion(rid) for rid in ids}
