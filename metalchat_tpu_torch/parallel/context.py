"""Context-parallel (sequence-parallel) prefill (port of the JAX package's
``parallel/context.py``).

A long prompt is split along the sequence over a mesh axis: each rank
embeds its block of the prompt and runs it through every layer, attending
with `ring_attention` while the K/V blocks go round the ring. Each layer's
K/V blocks are then gathered, so that the whole cache over the prompt
lands on every rank, and ordinary decode continues on any rank's cache.

Under a pipeline (``stages``: the grid of `parallel.pipeline.
make_pipeline_forward`, whose stages are the ranks of the axis in the same
order) each rank holds only its stage's layers and cache layers. The ring
then runs layer by layer in layer order: the stage that owns layer l hands
the layer's weights to every rank of the axis (one broadcast of its bytes,
counted ``layer_broadcast_<axis>``), every rank attends its block, and the
gathered K/V is written into the owning stage's cache only. A rank drops a
borrowed layer before it takes the next, so none holds another stage's
layers afterwards. The embedding and the final logits run on every rank,
as the pipeline runs them (every rank holds those leaves whole).

Restrictions, as JAX's: a fresh prompt (position 0), a dense FFN (no MoE),
no sliding-window layers, no biases, a dense or int8 (not paged) cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from metalchat_tpu_torch.cache import (
    KVCache,
    QuantizedKVCache,
    update_layer_cache,
    update_layer_cache_quantized,
)
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import GridMesh
from metalchat_tpu_torch.parallel.pipeline import map_leaf
from metalchat_tpu_torch.parallel.ring_attention import ring_attention

_ALIGN = 16  # bytes: every tensor of a handed-off layer starts aligned


def _borrow_layer(layers: Dict[str, Any], j: int, src: int, mesh: GridMesh,
                  axis: str) -> Dict[str, Any]:
    """Layer ``j`` of the stage at place ``src`` along ``axis``, on every
    rank of the axis: its tensors packed into one byte buffer that the
    owner broadcasts (counted ``layer_broadcast_<axis>``). Returns the
    one-layer tree (each leaf ``[1, ...]``, views of the buffer). This
    rank's own layer ``j`` gives the shapes and dtypes: every stage's layer
    ``j`` has the same."""
    own = []

    def take(t):
        own.append(t[j])
        return t

    for leaf in layers.values():
        map_leaf(leaf, take)
    starts, total = [], 0
    for t in own:
        starts.append(total)
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, device=own[0].device)
    if mesh.index(axis) == src:
        for t, at in zip(own, starts):
            flat = t.reshape(-1).view(torch.uint8)
            buf[at:at + flat.numel()].copy_(flat)
    buf = mesh.broadcast(buf, axis, src, kind="layer_broadcast")
    views = iter(buf[at:at + t.numel() * t.element_size()].view(t.dtype).view(1, *t.shape)
                 for t, at in zip(own, starts))
    return {k: map_leaf(v, lambda _: next(views)) for k, v in layers.items()}


def _stage_places(stages: GridMesh, mesh: GridMesh, axis: str) -> Tuple[int, int]:
    """(stages, this rank's stage) of a pipeline grid whose stages are the
    ranks of ``axis`` in the same order (stage s at place s)."""
    if stages.size("dp") != 1:
        raise NotImplementedError("context-parallel prefill over pipeline stages: dp 1 only")
    ranks = [stages._global(r) for r in stages.peers("pp")]
    if ranks != [mesh._global(r) for r in mesh.peers(axis)]:
        raise ValueError(f"context-parallel prefill over pipeline stages: the stages' ranks "
                         f"{ranks} must be the {axis} axis's, in order")
    return stages.size("pp"), stages.index("pp")


def context_parallel_prefill(params, cache, tokens: torch.Tensor, config: ModelConfig,
                             mesh: GridMesh, axis: str = "sp",
                             stages: Optional[GridMesh] = None) -> Tuple[torch.Tensor, object]:
    """Prefill the whole prompt ``tokens [B, S]`` (the same on every rank of
    ``axis``) with sequence-split ring attention: (the last position's f32
    logits ``[B, V]``, the cache filled over ``[0, S)`` in place).

    The prompt is padded to a multiple of the axis size; the padding's K/V
    lands past position S - 1, where decode writes before any read. The
    whole cache is written on every rank (the port's ``quantize_kv`` on an
    int8 cache, as `forward` writes it). The products are `linear`'s: on an
    act8 tree ``torch._int_mm`` on the card, with no kernel launch.

    With ``stages`` (a pipeline's grid of more than one stage) ``params``
    and ``cache`` are this rank's stage tree and stage cache
    (`parallel.pipeline.shard_params_pp` / `shard_cache_pp`): each layer
    comes from its stage (the module docstring) and only this stage's
    cache layers are written."""
    from metalchat_tpu_torch.models.transformer import (
        attention_inputs,
        attention_residual,
        embed_tokens,
        ffn_residual,
        final_logits,
    )

    if config.num_experts:
        raise NotImplementedError("context-parallel prefill: dense FFN only")
    if config.sliding_window is not None:
        raise NotImplementedError("context-parallel prefill: sliding-window layers unsupported")
    if config.use_bias:
        raise NotImplementedError("context-parallel prefill: bias-free models only")
    if not isinstance(cache, (KVCache, QuantizedKVCache)):
        raise NotImplementedError("context-parallel prefill: dense caches only")
    quantized = isinstance(cache, QuantizedKVCache)

    n, idx = mesh.size(axis), mesh.index(axis)
    b, s = tokens.shape
    pad = (-s) % n
    if pad:
        tokens = F.pad(tokens, (0, pad))
    s_pad = s + pad
    if s_pad > cache.max_seq_len:
        raise ValueError(f"prompt {s} (+{pad} pad) exceeds cache capacity")
    s_loc = s_pad // n
    dev = tokens.device
    positions = (idx * s_loc + torch.arange(s_loc, device=dev))[None, :].expand(b, s_loc)
    x = embed_tokens(params, tokens[:, idx * s_loc:(idx + 1) * s_loc], positions, config)
    n_stages, stage = ((1, 0) if stages is None or stages.size("pp") == 1
                       else _stage_places(stages, mesh, axis))
    per = config.num_layers // n_stages
    for l in range(config.num_layers):
        owner, j = divmod(l, per)
        if n_stages == 1 or owner == stage:
            layers, at = params["layers"], j
            if n_stages > 1:  # the collective: this stage hands its layer out
                _borrow_layer(layers, j, owner, mesh, axis)
        else:
            layers, at = _borrow_layer(params["layers"], j, owner, mesh, axis), 0
        q, k, v = attention_inputs(x, layers, at, config, params["rope"], positions,
                                   layer_id=l)
        attn = ring_attention(q, k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), mesh,
                              scale=config.attention_scale(), axis=axis)
        x = attention_residual(x, attn, layers, at, config)
        x, _ = ffn_residual(x, layers, at, config)
        del layers  # a borrowed layer goes before the next is taken
        kv = mesh.all_gather(torch.stack([k, v]), axis, dim=2)  # [2, B, S_pad, nkv, hd]
        if owner != stage:
            continue
        if quantized:
            update_layer_cache_quantized(cache.k[j], cache.v[j], cache.k_scale[j],
                                         cache.v_scale[j], kv[0], kv[1], 0)
        else:
            update_layer_cache(cache.k[j], cache.v[j], kv[0], kv[1], 0)
    # Position s - 1 lies in the block of rank (s - 1) // s_loc.
    owner, at = divmod(s - 1, s_loc)
    last = mesh.broadcast(x[:, at:at + 1].contiguous(), axis, owner)
    return final_logits(params, last, config)[:, 0], cache
