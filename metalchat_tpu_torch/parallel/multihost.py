"""Multi-process serving in lockstep (port of the JAX package's
``parallel/multihost.py`` ``MultiHostEngine`` and ``MultiHostRoundError``).

Every rank builds the same engine on its shard of the weights and runs the
same scheduling loop. The engine's host state is a function of the request
intake and of the sampled tokens, and the sampled tokens are the same on
every rank (the logits are gathered whole on every rank, the sampler's
generator is seeded alike), so the only traffic besides the model's
collectives is rank 0 broadcasting the request list.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import Mesh, shard_params
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
