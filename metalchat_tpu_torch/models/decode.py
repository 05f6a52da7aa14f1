"""Decode path: windows of 1 to 16 tokens (port of the JAX package's
``models/decode.py``, Llama and Gemma-3).

* Every act8 per-channel linear runs through the stacked matvec kernel
  (``ops.a8_matvec``) with the window's rows flattened to ``[B·S]``; wqkv
  and w13 take the rmsnorm prologue inside the kernel. lm_head rides the
  same kernel through a unit layer axis.
* S == 1 with an int8 cache: one fused kernel per layer quantizes the new
  K/V row, writes it in place and attends (``ops.decode_attention``); with
  a paged cache, the paged kernel does the same through the page table
  (``ops.paged_attention``), with ``lengths = offsets + 1``; with a cache in
  the activation dtype, an indexed write of the new row, then the same
  kernel's read-only mode (``decode_attention_stacked``).
* 1 < S ≤ 16: the cache is updated in place and the
  reference attention runs over the layer's dequantized cache (a paged
  cache: each row's gathered pages) with a causal window mask, the
  semantics of the JAX package's scan path for paged windows.
* ``ffn_block=True`` (off by default, as in the JAX package): each layer's
  post-attention block (wo → residual → ffn-norm → w13 → act → w2 →
  residual) is one ``ops.ffn_block`` launch when the layer qualifies.
* Weight-only leaves go through `linear`: up to 32 rows take the
  dequant-matmul kernel (``ops.quant_matmul``).
* Gemma-3 (as the JAX ``decode_step``): the norm weight offset inside the
  matvec's rmsnorm prologue, q/k norms, the sliding layers' rope table and
  window (a host int per layer, -1 on a global layer, so a captured step
  bakes it in), ``query_scale``, post-attention and post-FFN norms and
  gelu-tanh. The merged FFN block has no post-FFN norm: it is off for a
  config with post-norms, as in the JAX package.

Dense linear leaves take a plain product. The TPU-only gates of the JAX
path (Mosaic head-dim rules, block choice, lane alignment) do not apply.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from metalchat_tpu_torch.cache import (
    PagedKVCache,
    QuantizedKVCache,
    dequantize_kv,
    positions_to_pages,
    update_stacked_layer_cache,
    update_stacked_layer_cache_quantized,
)
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import (
    act_gate,
    embed_tokens,
    layer_leaf,
    layer_rope,
    norm,
    paged_layer_kv,
)
from metalchat_tpu_torch.ops import ffn_block as fb
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.ops.a8_matvec import MAX_ROWS, quant_matvec_stacked_fused
from metalchat_tpu_torch.ops.decode_attention import (
    decode_attention_stacked,
    decode_attention_update_quantized_stacked,
)
from metalchat_tpu_torch.ops.paged_attention import paged_decode_attention_update_stacked
from metalchat_tpu_torch.quant.quantize import QuantizedTensor, linear


def _kernel_ok(leaf: Any, rows: int) -> bool:
    """The matvec kernel covers act8 per-channel transposed storage, up to
    16 rows, with in-features a multiple of 32."""
    return (isinstance(leaf, QuantizedTensor) and leaf.act_bits == 8
            and leaf.transposed and leaf.group_size == leaf.in_features
            and rows <= MAX_ROWS and leaf.in_features % 32 == 0)


def _ffn_block_ok(layers: Dict[str, Any], rows: int, dtype, config: ModelConfig) -> bool:
    """The merged block's gate (the JAX package's, without the Mosaic block
    rules): no post-norms, act8 per-channel transposed wo, w13 (fused) and
    w2 of one ``bits``, an ffn norm in the activation dtype, wo's input as
    wide as the hidden state, and shapes the kernel takes."""
    if config.use_post_norms:
        return False
    leaves = [layers.get(n) for n in ("wo", "w13", "w2")]
    if not all(isinstance(w, QuantizedTensor) and w.q.ndim == 3 and _kernel_ok(w, rows)
               for w in leaves):
        return False
    wo, w13, _ = leaves
    norm = layers["ffn_norm"]
    return (len({w.bits for w in leaves}) == 1 and norm.dtype == dtype
            and wo.in_features == config.hidden_size
            and fb.supported(rows, config.hidden_size, w13.out_features // 2))


def decode_step(params: Dict[str, Any], cache, tokens: torch.Tensor, start_pos,
                config: ModelConfig, *, ffn_block: bool = False):
    """One decode window ``tokens [B, S]`` (S ≤ 16) at ``start_pos``; same
    contract as `forward`. The cache is updated in place. ``start_pos`` is
    an int, or an integer device tensor, 0-d (shared) or ``[B]`` (per row).
    A tensor is never read back to the host, so a one-token step (S == 1)
    captured in a CUDA graph reads the position from that tensor at every
    replay (`engine.generate`); windows of 2-16 tokens may read it.
    ``ffn_block`` merges each layer's post-attention block into one kernel
    launch where `_ffn_block_ok` holds."""
    b, s = tokens.shape
    dev = tokens.device
    if torch.is_tensor(start_pos):
        offsets = start_pos.to(device=dev, dtype=torch.int64).reshape(-1).expand(b)
    else:
        offsets = torch.full((b,), int(start_pos), dtype=torch.int64, device=dev)
    positions = offsets[:, None] + torch.arange(s, device=dev)[None, :]
    lengths = (offsets + s).to(torch.int32)

    layers = params["layers"]
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim
    eps, mu = config.rms_norm_eps, config.norm_weight_offset
    scale = config.attention_scale()
    rows = b * s
    quantized = isinstance(cache, QuantizedKVCache)
    paged = isinstance(cache, PagedKVCache)
    if paged:
        kv_len = cache.page_table.shape[1] * cache.page_size
        paged_at = positions_to_pages(cache.page_table, positions, cache.page_size) \
            if s > 1 else None
    else:
        kv_len = cache.k.shape[3]

    x = embed_tokens(params, tokens, config).reshape(rows, -1)
    merged = ffn_block and _ffn_block_ok(layers, rows, x.dtype, config)
    # Rope rows of the window's positions, [B, S, hd/2], gathered once a
    # step per table (Gemma-3's sliding layers take the local one).
    rope_rows = {name: table[positions] for name, table in params["rope"].items()}

    def norm_linear(x_res, name: str, norm_name: str, l: int, normed: dict):
        """layers[name] @ rmsnorm(x_res): inside the kernel when it applies,
        else one normed activation shared by the layer's projections."""
        leaf = layers[name]
        norm_w = layers[norm_name]
        if _kernel_ok(leaf, rows) and norm_w.dtype == x_res.dtype:
            return quant_matvec_stacked_fused(x_res, leaf.q, leaf.scales, l,
                                              bits=leaf.bits, norm_stack=norm_w,
                                              norm_eps=eps, norm_offset=mu)
        if norm_name not in normed:
            normed[norm_name] = norm(x_res, norm_w[l], config)
        return linear_l(normed[norm_name], name, l)

    def linear_l(h, name: str, l: int):
        leaf = layers[name]
        if _kernel_ok(leaf, rows):
            return quant_matvec_stacked_fused(h, leaf.q, leaf.scales, l, bits=leaf.bits)
        return linear(h, layer_leaf(leaf, l))

    for l in range(config.num_layers):
        normed: dict = {}
        if "wqkv" in layers:
            q, k, v = norm_linear(x, "wqkv", "attn_norm", l, normed).split(
                [nh * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q, k, v = (norm_linear(x, n, "attn_norm", l, normed)
                       for n in ("wq", "wk", "wv"))
        q, k = q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd)
        if config.use_qk_norm:
            q = norm(q, layers["q_norm"][l], config)
            k = norm(k, layers["k_norm"][l], config)
        cos, sin = layer_rope(rope_rows, config, l)
        q = ops.apply_rope_rows(q, cos, sin)
        k = ops.apply_rope_rows(k, cos, sin)
        v = v.reshape(b, s, nkv, hd)
        window = config.layer_window(l)

        if paged and s == 1:
            attn, *_ = paged_decode_attention_update_stacked(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
                cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale,
                cache.page_table, lengths, l, scale=scale, window=window)
        elif quantized and s == 1:
            attn, *_ = decode_attention_update_quantized_stacked(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
                cache.k, cache.v, cache.k_scale, cache.v_scale, l, lengths,
                scale=scale, window=window)
        elif s == 1:
            # Per-row positions as tensor indices: no host sync.
            batch = torch.arange(b, device=dev)
            cache.k[l][batch, :, offsets] = k[:, 0].to(cache.k.dtype)
            cache.v[l][batch, :, offsets] = v[:, 0].to(cache.v.dtype)
            attn = decode_attention_stacked(q[:, 0].contiguous(), cache.k, cache.v, l,
                                            lengths, scale=scale, window=window)
        else:
            if paged:
                keys, values = paged_layer_kv(cache, l, k, v, *paged_at, x.dtype)
            elif quantized:
                update_stacked_layer_cache_quantized(
                    cache.k, cache.v, cache.k_scale, cache.v_scale, k, v, l, start_pos)
                keys = dequantize_kv(cache.k[l], cache.k_scale[l], x.dtype)
                values = dequantize_kv(cache.v[l], cache.v_scale[l], x.dtype)
            else:
                update_stacked_layer_cache(cache.k, cache.v, k, v, l, start_pos)
                keys, values = cache.k[l], cache.v[l]
            mask = ops.causal_mask(positions, kv_len, lengths[:, None, None],
                                   None if window < 0 else window)
            attn = ops.attention(q, keys, values, mask, scale=scale)
        attn = attn.reshape(rows, nh * hd)
        if merged:
            x = fb.ffn_block_stacked(
                attn.contiguous(), x, layers["wo"].q, layers["wo"].scales, layers["ffn_norm"],
                layers["w13"].q, layers["w13"].scales, layers["w2"].q, layers["w2"].scales,
                l, bits=layers["wo"].bits, act=config.hidden_act, eps=eps, offset=mu)
            continue
        attn = linear_l(attn, "wo", l)
        if config.use_post_norms:
            attn = norm(attn, layers["post_attn_norm"][l], config)
        x = x + attn

        normed = {}
        if "w13" in layers:
            ffn = linear_l(act_gate(norm_linear(x, "w13", "ffn_norm", l, normed),
                                    config.hidden_act), "w2", l)
        else:
            gate = ops.activation(config.hidden_act)(
                norm_linear(x, "w1", "ffn_norm", l, normed))
            ffn = linear_l(gate * norm_linear(x, "w3", "ffn_norm", l, normed), "w2", l)
        if config.use_post_norms:
            ffn = norm(ffn, layers["post_ffn_norm"][l], config)
        x = x + ffn

    x = norm(x, params["final_norm"], config)
    lm_head = params["lm_head"]
    if isinstance(lm_head, QuantizedTensor) and lm_head.q.ndim == 2 \
            and _kernel_ok(lm_head, rows):
        logits = quant_matvec_stacked_fused(x, lm_head.q[None], lm_head.scales[None],
                                            0, bits=lm_head.bits)
    else:
        logits = linear(x, lm_head)
    return logits.float().reshape(b, s, -1), cache
