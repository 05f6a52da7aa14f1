"""Pipeline parallelism: layer stages over a "pp" axis (port of the JAX
package's ``parallel/pipeline.py``).

The stacked-layer axis is split over ``pp``: each rank holds L/pp
contiguous layers and their slice of the KV cache, and a GPipe schedule
streams microbatches through the stages, handing each stage's activations
to the next one every tick (`GridMesh.shift`, JAX's ``ppermute``). A stage
whose tick has no microbatch runs nothing and writes no cache (JAX's
``lax.cond``), so at one microbatch a stage runs exactly the layer steps of
the single-process `forward`, with the same kernels in the same order. The
pipeline composes with ``dp`` on the same grid: each dp row holds its
B/dp batch rows of the cache and runs its own pipeline.

One process runs per rank, in lockstep (`GridMesh`): every rank embeds the
tokens of its dp row, the last stage's outputs are made whole on every rank
of the pipeline (`GridMesh.broadcast`, JAX's masked ``psum``), every rank
runs the final norm and lm_head, and the logits of the whole batch are
gathered over dp, as JAX's global array holds them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import GridMesh, make_grid_mesh
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor


def make_pp_mesh(pp: int, dp: int = 1) -> GridMesh:
    """This process's view of a ("dp", "pp") grid over the default process
    group, which must hold ``dp * pp`` ranks (one process without a group:
    ``dp * pp`` must be 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * pp != world:
        raise ValueError(f"dp*pp = {dp}*{pp} != {world} processes")
    return make_grid_mesh({"dp": dp, "pp": pp})


def _stage(t: torch.Tensor, stage: int, n: int, rows: slice = slice(None)) -> torch.Tensor:
    """Part ``stage`` of ``n`` of ``t``'s leading axis (and ``rows`` of its
    second), a copy of its own."""
    if t.shape[0] % n:
        raise ValueError(f"leading axis of {tuple(t.shape)} not divisible by pp={n}")
    part = t.shape[0] // n
    return t[stage * part:(stage + 1) * part, rows].clone()


def map_leaf(leaf: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``leaf`` (a tensor, `QuantizedTensor` or `LoraLinear`) with ``fn``
    applied to each of its tensors, in one fixed order (q before scales;
    base, a, b)."""
    if isinstance(leaf, QuantizedTensor):
        return replace(leaf, q=fn(leaf.q), scales=fn(leaf.scales))
    if isinstance(leaf, LoraLinear):
        return replace(leaf, base=map_leaf(leaf.base, fn), a=fn(leaf.a), b=fn(leaf.b))
    return fn(leaf)


def shard_params_pp(params: Dict[str, Any], mesh: GridMesh) -> Dict[str, Any]:
    """This rank's tree (JAX's ``pipeline_param_shardings``): its stage's
    contiguous L/pp layers of every stacked leaf, as copies (the caller may
    free the whole tree); every other leaf whole, shared with the caller."""
    pp = mesh.size("pp")
    if pp == 1:
        return params
    stage = mesh.index("pp")
    return {**params, "layers": {k: map_leaf(v, lambda t: _stage(t, stage, pp))
                                 for k, v in params["layers"].items()}}


def _check_cache(cache) -> None:
    if not isinstance(cache, (KVCache, QuantizedKVCache)):
        raise NotImplementedError(
            f"pipeline parallelism takes a dense or int8 KV cache, not "
            f"{type(cache).__name__} (paged KV pairs with continuous batching on a tp "
            "mesh: page tables are per-host)")


def shard_cache_pp(cache, mesh: GridMesh):
    """This rank's cache (JAX's ``P("pp", "dp")``): its stage's layers and
    its dp row's batch rows of a dense or int8 cache ``[L, B, ...]``, as
    copies. Paged caches are refused."""
    _check_cache(cache)
    (pp, stage), (dp, row) = ((mesh.size(a), mesh.index(a)) for a in ("pp", "dp"))
    if cache.k.shape[1] % dp:
        raise ValueError(f"batch {cache.k.shape[1]} not divisible by dp={dp}")
    b = cache.k.shape[1] // dp
    return type(cache)(**{f.name: _stage(getattr(cache, f.name), stage, pp,
                                         slice(row * b, (row + 1) * b))
                          for f in dataclasses.fields(cache)})


def _cache_rows(cache, start: int, size: int):
    """Rows ``[start, start + size)`` of every cache tensor (views, so the
    layer steps write the cache in place)."""
    return type(cache)(**{f.name: getattr(cache, f.name)[:, start:start + size]
                          for f in dataclasses.fields(cache)})


def make_pipeline_forward(config: ModelConfig, mesh: GridMesh, *, n_microbatches: int = 1,
                          remat: bool = False):
    """``fn(params, cache, tokens, start_pos) → (logits, cache)``: the
    layer stack as a pp-stage pipeline, the embedding and lm_head on every
    rank. ``params`` is this rank's tree (`shard_params_pp`), ``cache`` its
    cache (`shard_cache_pp`, written in place), ``tokens [B, S]`` the whole
    batch (the same on every rank) written at ``start_pos`` (an int, or an
    integer tensor: 0-d, or ``[B]`` per-row offsets); the f32 logits ``[B,
    S, V]`` of the whole batch come back on every rank.

    Requirements, as JAX's: num_layers % pp == 0 and batch % (dp ·
    n_microbatches) == 0. Every stage runs `run_layers`, the layer route
    (flash attention for windows of over 16 tokens, one ``decode_attention``
    launch a local layer at one token where the cache's length allows it),
    as JAX's stages run ``run_layers``. The function carries ``collectives
    = True``: `DecodeStep` and the engine run its steps eagerly."""
    from metalchat_tpu_torch.models.transformer import (
        embed_tokens,
        final_logits,
        layer_inputs,
        run_layers,
    )

    n_stages = mesh.size("pp")
    if config.num_layers % n_stages:
        raise ValueError(f"num_layers={config.num_layers} not divisible by pp={n_stages}")
    stage, dp, row = mesh.index("pp"), mesh.size("dp"), mesh.index("dp")
    first_layer = stage * (config.num_layers // n_stages)
    last = n_stages - 1
    n_mb = n_microbatches

    def fn(params, cache, tokens, start_pos):
        _check_cache(cache)
        b, s = tokens.shape
        if (b // dp) % n_mb:
            raise ValueError(f"per-dp batch not divisible by {n_mb} microbatches")
        b_loc = b // dp
        if cache.k.shape[1] != b_loc:
            raise ValueError(f"the cache holds {cache.k.shape[1]} rows; this dp row's "
                             f"batch is {b_loc} of {b}")
        per_row = torch.is_tensor(start_pos) and start_pos.ndim == 1
        tokens = tokens[row * b_loc:(row + 1) * b_loc]
        if per_row:
            start_pos = start_pos[row * b_loc:(row + 1) * b_loc]
        x = embed_tokens(params, tokens, layer_inputs(tokens, start_pos, cache)["positions"],
                         config)
        mb = b_loc // n_mb
        x_mb = x.reshape(n_mb, mb, *x.shape[1:])
        outs = torch.zeros_like(x_mb)
        acts = torch.zeros_like(x_mb[0])
        ticks = n_mb + n_stages - 1
        for t in range(ticks):
            m = t - stage  # this stage's microbatch at tick t
            y = x_mb[min(t, n_mb - 1)] if stage == 0 else acts
            if 0 <= m < n_mb:
                rows = slice(m * mb, (m + 1) * mb)
                sub = _cache_rows(cache, m * mb, mb)
                y, _ = run_layers(y, params["layers"], sub, config=config, rope=params["rope"],
                                  first_layer=first_layer, remat=remat,
                                  **layer_inputs(tokens[rows],
                                                 start_pos[rows] if per_row else start_pos,
                                                 sub))
                if stage == last:
                    outs[m] = y
            if t + 1 < ticks:  # the last tick's hand-off would carry nothing read
                acts = mesh.shift(y, "pp", wrap=False)
        out = mesh.broadcast(outs.reshape(x.shape), "pp", last)
        logits = mesh.all_gather(final_logits(params, out, config), "dp", dim=0)
        return logits, cache

    fn.collectives = True
    # The stages' grid: a context-parallel prefill (`parallel.context`) given
    # this forward's params and cache runs over the stages' own layers.
    fn.stages = mesh
    return fn
