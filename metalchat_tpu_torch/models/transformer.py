"""Decoder-only transformer, Llama and Gemma-3: the prefill path (port of
the JAX package's ``models/transformer.py``).

Parameter tree (same keys and layouts as the JAX package; per-layer leaves
stacked on a leading layer axis):

  params = {
    "embed": [V, H],
    "layers": {"attn_norm": [L, H], "wqkv" | "wq"/"wk"/"wv", "wo",
               "ffn_norm": [L, H], "w13" | "w1"/"w3", "w2",
               Gemma-3 only: "q_norm", "k_norm": [L, hd],
               "post_attn_norm", "post_ffn_norm": [L, H]},
    "final_norm": [H], "lm_head": [H, V] or QuantizedTensor,
    "rope": {"cos", "sin": [S_max, hd/2]; Gemma-3 also
             "cos_local", "sin_local" at rope_local_theta},
  }

Dense linear leaves are ``[L, in, out]``; quantized ones are
``QuantizedTensor`` (act8: ``q [L, out, in/2]``, scales ``[L, 1, out]``;
weight-only: either orientation, group scales).
The layer loop is a Python loop over views of the stacked leaves. Gemma-3's
extras follow the config: every norm's weight is ``norm_weight_offset + w``,
q/k norms over hd, post-attention and post-FFN norms, the embedding scale,
gelu-tanh, ``query_scale``, and sliding layers (``config.layer_window``)
with their own rope table.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from metalchat_tpu_torch.cache import (
    KVCache,
    PagedKVCache,
    QuantizedKVCache,
    dequantize_kv,
    gather_page_scales,
    gather_pages_dense,
    positions_to_pages,
    update_layer_cache,
    update_layer_cache_quantized,
    write_paged_layer,
)
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.ops.flash_attention import flash_attention
from metalchat_tpu_torch.quant.quantize import (
    QuantizedTensor,
    linear,
    lookup_embedding,
)

Params = Dict[str, Any]
Cache = Union[KVCache, QuantizedKVCache, PagedKVCache]

# Windows of at most this many tokens take the decode path (as in the JAX
# package: weights are read once per window through the matvec kernel).
DECODE_MAX_TOKENS = 16


def layer_leaf(leaf, l: int):
    """Layer ``l`` of a stacked linear leaf (a view, no copy)."""
    return leaf.layer(l) if isinstance(leaf, QuantizedTensor) else leaf[l]


def make_rope_tables(config: ModelConfig, max_seq_len: Optional[int] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Precompute rope cos/sin ``[S_max, hd/2]`` (f32), and with
    ``rope_local_theta`` the sliding layers' tables (no scaling)."""
    s = max_seq_len or config.max_seq_len
    cos, sin = ops.precompute_rope(config.head_dim, s, config.rope_theta,
                                   config.rope_scaling, device=device)
    tables = {"cos": cos, "sin": sin}
    if config.rope_local_theta is not None:
        tables["cos_local"], tables["sin_local"] = ops.precompute_rope(
            config.head_dim, s, config.rope_local_theta, device=device)
    return tables


def layer_rope(rope: Dict[str, torch.Tensor], config: ModelConfig, l: int):
    """Layer ``l``'s cos/sin (tables, or rows gathered from them): the
    local ones on a sliding layer."""
    if "cos_local" in rope and not config.layer_is_global(l):
        return rope["cos_local"], rope["sin_local"]
    return rope["cos"], rope["sin"]


def norm(x: torch.Tensor, w: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """rmsnorm with the config's eps and weight offset."""
    return ops.rms_norm(x, w, eps=config.rms_norm_eps, offset=config.norm_weight_offset)


def embed_tokens(params: Params, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token embedding in the activation dtype (that of ``final_norm``),
    times ``embedding_scale`` rounded to that dtype first, as the JAX
    package multiplies."""
    x = lookup_embedding(tokens, params["embed"]).to(params["final_norm"].dtype)
    if config.embedding_scale is not None:
        x = x * torch.tensor(config.embedding_scale, dtype=x.dtype).item()
    return x


def final_logits(params: Params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Final norm + lm head → f32 logits."""
    return linear(norm(x, params["final_norm"], config), params["lm_head"]).float()


def act_gate(fused: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act(gate) * up`` of a fused w13 output ``[.., 2F]``."""
    gate, up = fused.chunk(2, dim=-1)
    return ops.activation(act)(gate) * up


def paged_layer_kv(cache: PagedKVCache, l: int, k, v, pages, offsets, dtype):
    """Write k/v ``[B, S, n_kv, hd]`` into layer ``l``'s pages in place, then
    each row's pages gathered and dequantized to ``dtype`` → keys, values
    ``[B, n_kv, MP·psize, hd]``."""
    kp, vp, ksc, vsc = (t[l] for t in (cache.k_pages, cache.v_pages, cache.k_scale,
                                       cache.v_scale))
    write_paged_layer(kp, vp, ksc, vsc, k, v, pages, offsets)
    pt = cache.page_table
    return (dequantize_kv(gather_pages_dense(kp, pt), gather_page_scales(ksc, pt), dtype),
            dequantize_kv(gather_pages_dense(vp, pt), gather_page_scales(vsc, pt), dtype))


def _layer_step(x, layers: Params, l: int, cache: Cache, config: ModelConfig,
                rope, positions, start_pos, kv_end: int, paged_at=None) -> torch.Tensor:
    b, s, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim

    h = norm(x, layers["attn_norm"][l], config)
    if "wqkv" in layers:
        q, k, v = linear(h, layer_leaf(layers["wqkv"], l)).split(
            [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = (linear(h, layer_leaf(layers[n], l)) for n in ("wq", "wk", "wv"))
    q, k = q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd)
    if config.use_qk_norm:
        q = norm(q, layers["q_norm"][l], config)
        k = norm(k, layers["k_norm"][l], config)
    cos, sin = layer_rope(rope, config, l)
    q = ops.apply_rope(q, cos, sin, positions)
    k = ops.apply_rope(k, cos, sin, positions)
    v = v.reshape(b, s, nkv, hd)

    if isinstance(cache, PagedKVCache):
        # Prefill attends over the row's whole page table, dequantized.
        keys, values = paged_layer_kv(cache, l, k, v, *paged_at, x.dtype)
    elif isinstance(cache, QuantizedKVCache):
        ck, cv, sk, sv = update_layer_cache_quantized(
            cache.k[l], cache.v[l], cache.k_scale[l], cache.v_scale[l], k, v,
            start_pos)
        # Prefill attends over the cache dequantized to the activation dtype.
        keys = dequantize_kv(ck[:, :, :kv_end], sk[:, :, :kv_end], x.dtype)
        values = dequantize_kv(cv[:, :, :kv_end], sv[:, :, :kv_end], x.dtype)
    else:
        ck, cv = update_layer_cache(cache.k[l], cache.v[l], k, v, start_pos)
        keys, values = ck[:, :, :kv_end].contiguous(), cv[:, :, :kv_end].contiguous()
    attn = flash_attention(q.contiguous(), keys, values, start_pos,
                           scale=config.attention_scale(), window=config.layer_window(l))
    attn = linear(attn.reshape(b, s, nh * hd), layer_leaf(layers["wo"], l))
    if config.use_post_norms:
        attn = norm(attn, layers["post_attn_norm"][l], config)
    x = x + attn

    h = norm(x, layers["ffn_norm"][l], config)
    if "w13" in layers:
        ffn = linear(act_gate(linear(h, layer_leaf(layers["w13"], l)), config.hidden_act),
                     layer_leaf(layers["w2"], l))
    else:
        ffn = ops.swiglu(h, layer_leaf(layers["w1"], l), layer_leaf(layers["w3"], l),
                         layer_leaf(layers["w2"], l), config.hidden_act, matmul=linear)
    if config.use_post_norms:
        ffn = norm(ffn, layers["post_ffn_norm"][l], config)
    return x + ffn


def forward(params: Params, cache: Cache, tokens: torch.Tensor, start_pos,
            config: ModelConfig, *, ffn_block: bool = False):
    """One model step: tokens int ``[B, S]`` written at ``start_pos`` (an int,
    or an integer tensor: 0-d, or ``[B]`` per-row offsets). Returns (f32
    logits ``[B, S, V]``, cache), the cache updated in place.

    Windows of up to 16 tokens take `decode_step` (the matvec kernel path),
    as in the JAX package, which reads a tensor ``start_pos`` on the device
    only; longer ones are the prefill path below, with
    flash attention over the dequantized cache (a paged cache: over each
    row's gathered pages). ``ffn_block`` is `decode_step`'s: the merged
    post-attention kernel on decode windows (prefill is not affected)."""
    b, s = tokens.shape
    if s <= DECODE_MAX_TOKENS:
        from metalchat_tpu_torch.models.decode import decode_step

        return decode_step(params, cache, tokens, start_pos, config, ffn_block=ffn_block)
    paged = isinstance(cache, PagedKVCache)
    if torch.is_tensor(start_pos) and start_pos.ndim == 1:
        offsets = start_pos.to(device=tokens.device, dtype=torch.int64)
        # A paged prefill reads whole page tables: no host read of the ends.
        kv_end = 0 if paged else int(offsets.max()) + s
    else:
        start_pos = int(start_pos)
        offsets = torch.full((b,), start_pos, dtype=torch.int64, device=tokens.device)
        kv_end = start_pos + s
    positions = offsets[:, None] + torch.arange(s, device=tokens.device)[None, :]
    paged_at = positions_to_pages(cache.page_table, positions, cache.page_size) \
        if paged else None

    x = embed_tokens(params, tokens, config)
    for l in range(config.num_layers):
        x = _layer_step(x, params["layers"], l, cache, config, params["rope"],
                        positions, start_pos, kv_end, paged_at)
    return final_logits(params, x, config), cache
