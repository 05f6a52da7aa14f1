"""Context-parallel (sequence-parallel) prefill (port of the JAX package's
``parallel/context.py``).

A long prompt is split along the sequence over a mesh axis: each rank
embeds its block of the prompt and runs it through every layer, attending
with `ring_attention` while the K/V blocks go round the ring. Each layer's
K/V blocks are then gathered, so that the whole cache over the prompt
lands on every rank, and ordinary decode continues on any rank's cache.

Restrictions, as JAX's: a fresh prompt (position 0), a dense FFN (no MoE),
no sliding-window layers, no biases, a dense or int8 (not paged) cache.
"""

from __future__ import annotations

from typing import Tuple

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
from metalchat_tpu_torch.parallel.ring_attention import ring_attention


def context_parallel_prefill(params, cache, tokens: torch.Tensor, config: ModelConfig,
                             mesh: GridMesh, axis: str = "sp") -> Tuple[torch.Tensor, object]:
    """Prefill the whole prompt ``tokens [B, S]`` (the same on every rank of
    ``axis``) with sequence-split ring attention: (the last position's f32
    logits ``[B, V]``, the cache filled over ``[0, S)`` in place).

    The prompt is padded to a multiple of the axis size; the padding's K/V
    lands past position S - 1, where decode writes before any read. The
    whole cache is written on every rank (the port's ``quantize_kv`` on an
    int8 cache, as `forward` writes it). The products are `linear`'s: on an
    act8 tree ``torch._int_mm`` on the card, with no kernel launch."""
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
    layers = params["layers"]
    for l in range(config.num_layers):
        q, k, v = attention_inputs(x, layers, l, config, params["rope"], positions)
        attn = ring_attention(q, k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), mesh,
                              scale=config.attention_scale(), axis=axis)
        x = attention_residual(x, attn, layers, l, config)
        x, _ = ffn_residual(x, layers, l, config)
        kv = mesh.all_gather(torch.stack([k, v]), axis, dim=2)  # [2, B, S_pad, nkv, hd]
        if quantized:
            update_layer_cache_quantized(cache.k[l], cache.v[l], cache.k_scale[l],
                                         cache.v_scale[l], kv[0], kv[1], 0)
        else:
            update_layer_cache(cache.k[l], cache.v[l], kv[0], kv[1], 0)
    # Position s - 1 lies in the block of rank (s - 1) // s_loc.
    owner, at = divmod(s - 1, s_loc)
    last = mesh.broadcast(x[:, at:at + 1].contiguous(), axis, owner)
    return final_logits(params, last, config)[:, 0], cache
