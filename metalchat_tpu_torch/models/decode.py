"""Decode path: windows of 1 to 16 tokens (port of the JAX package's
``models/decode.py``, Llama, Gemma-3, Mixtral and GPT-2).

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
* 1 < S ≤ 16 on a dense cache: the cache is updated in place (at a tensor
  position through device indices) and the reference attention runs over
  the layer's (dequantized) cache with a causal window mask. A paged cache takes one token only: `forward` sends
  its longer windows to the layer route, as the JAX package does
  (`supports_fast_decode`).
* ``ffn_block=True`` (off by default, as in the JAX package): each layer's
  post-attention block (wo → residual → ffn-norm → w13 → act → w2 →
  residual) is one ``ops.ffn_block`` launch when the layer qualifies.
* Weight-only leaves go through `linear`: up to 32 rows take the
  dequant-matmul kernel (``ops.quant_matmul``).
* A LoRA leaf (``LoraLinear``, as the JAX ``_linear_l``): its base goes
  where a plain leaf would (the matvec kernel for an act8 base, else
  `linear`), then the adaptor product is added on top (`add_adaptor`). It
  never takes the kernel's rmsnorm prologue: its projections read one
  normed activation. The merged FFN block refuses LoRA leaves.
* Gemma-3 (as the JAX ``decode_step``): the norm weight offset inside the
  matvec's rmsnorm prologue, q/k norms, the sliding layers' rope table and
  window (a host int per layer, -1 on a global layer, so a captured step
  bakes it in), ``query_scale``, post-attention and post-FFN norms and
  gelu-tanh. The merged FFN block has no post-FFN norm: it is off for a
  config with post-norms, as in the JAX package.

* Mixtral (``_moe_ffn_decode``): the router in plain PyTorch, then the
  experts through the same matvec kernel over the flattened ``[L·E, out,
  k]`` stack. Chosen statically, as in the JAX package: when T·K ≤ E/2
  (T rows, K choices of E experts) one call a (row, choice) on the routed
  expert ``l·E + topk[row, j]``, passed as a 0-d device tensor that the
  kernel reads, so the step reads nothing back and a CUDA graph captures
  it; otherwise every expert on all rows at the host index ``l·E + e``,
  the gates selecting (exact either way). No merged FFN block for MoE.
* GPT-2 (as the JAX ``decode_step``): learned positions added to the
  embedding at the window's device positions (no rope), layernorm run
  outside the kernel (the matvec has an rmsnorm prologue only, so the
  projections take the normed activation, as JAX's ``fuse_norms`` is off
  for layernorm), each projection's bias added after its product in the
  activation dtype, the biased gelu MLP (w1, w2; no w3) and the final
  layernorm. The merged FFN block takes no biases: it is off under
  ``use_bias``, as in the JAX package.
* Tensor parallelism (``tp``, the JAX package's ``tp_axis``): the rank's
  local tree and cache at the local head and FFN counts, the embedding a
  masked lookup over the rank's vocabulary rows and one ``all_reduce``, one
  ``all_reduce`` after wo and one after w2 in the activation dtype, the
  lm_head over the rank's vocabulary columns and the whole logits gathered
  on every rank (`parallel.tp_decode`). Row-parallel matvecs quantize their
  local slice (per shard, as JAX's ``shard_map`` body). Biases are refused
  and the merged FFN block is off, as in JAX. MoE (a mesh whose ep is 1):
  every rank routes alike on the whole router, each routed expert runs at
  the rank's FFN width F/tp through the same matvec calls (the indexed
  entry at w1/w3 ``[F/tp, H]`` and w2 ``[H, F/tp]``, w2's act-quant on the
  rank's slice), and the post-FFN ``all_reduce`` joins w2's partial sums.

Dense linear leaves take a plain product. The TPU-only gates of the JAX
path (Mosaic head-dim rules, block choice, lane alignment) do not apply.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict

import torch

from metalchat_tpu_torch.cache import (
    PagedKVCache,
    QuantizedKVCache,
    dequantize_kv,
    update_stacked_layer_cache,
    update_stacked_layer_cache_quantized,
)
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.moe import route
from metalchat_tpu_torch.models.transformer import (
    DECODE_MAX_TOKENS,
    act_gate,
    biased,
    embed_tokens,
    layer_leaf,
    layer_rope,
    norm,
    rms_norm,
    split_qkv,
    tp_config,
)
from metalchat_tpu_torch.ops import ffn_block as fb
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.ops.a8_matvec import MAX_ROWS, quant_matvec_stacked_fused
from metalchat_tpu_torch.ops.decode_attention import (
    decode_attention_stacked,
    decode_attention_update_quantized_stacked,
)
from metalchat_tpu_torch.ops.paged_attention import paged_decode_attention_update_stacked
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor, add_adaptor, linear


def _kernel_ok(leaf: Any, rows: int) -> bool:
    """The matvec kernel covers act8 per-channel transposed storage, up to
    16 rows, with in-features a multiple of 32."""
    return (isinstance(leaf, QuantizedTensor) and leaf.act_bits == 8
            and leaf.transposed and leaf.group_size == leaf.in_features
            and leaf.pack_chunks == 1 and rows <= MAX_ROWS
            and leaf.in_features % 32 == 0)


def _linear_l(h: torch.Tensor, leaf: Any, l: int, rows: int) -> torch.Tensor:
    """h ``[rows, in]`` through layer ``l`` of a stacked linear leaf: the
    matvec kernel for an act8 per-channel leaf, `linear` otherwise; a LoRA
    leaf's base the same way, then its adaptor (the JAX ``_linear_l``)."""
    if isinstance(leaf, LoraLinear):
        return add_adaptor(h, _linear_l(h, leaf.base, l, rows), leaf.a[l], leaf.b[l],
                           leaf.scale)
    if _kernel_ok(leaf, rows):
        return quant_matvec_stacked_fused(h, leaf.q, leaf.scales, l, bits=leaf.bits)
    return linear(h, layer_leaf(leaf, l))


def _ffn_block_ok(layers: Dict[str, Any], rows: int, dtype, config: ModelConfig) -> bool:
    """The merged block's gate (the JAX package's, without the Mosaic block
    rules): no post-norms, no biases, no layernorm, act8 per-channel
    transposed wo, w13 (fused) and w2 of one ``bits``, an ffn norm in the
    activation dtype, wo's input as wide as the hidden state, and shapes the
    kernel takes."""
    if (config.use_post_norms or config.num_experts or config.use_bias
            or config.norm_type == "layernorm"):
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


def _entry(stack: torch.Tensor, flat_idx) -> torch.Tensor:
    """Entry ``flat_idx`` of ``stack [N, ...]``: a view at an int, a gather
    on the device at a tensor index (indexing with a 0-d tensor reads it on
    the host)."""
    if torch.is_tensor(flat_idx):
        return stack.index_select(0, flat_idx.reshape(1))[0]
    return stack[flat_idx]


def _expert_linear_l(x: torch.Tensor, leaf: Any, flat_idx) -> torch.Tensor:
    """x ``[T, in]`` through expert ``flat_idx`` (``l·E + e``: an int, or a
    0-d int32 tensor on x's device) of an ``[L, E, ...]`` expert stack,
    addressed as the flattened ``[L·E, ...]`` stack."""
    if isinstance(leaf, QuantizedTensor):
        q = leaf.q.reshape((-1,) + leaf.q.shape[2:])
        scales = leaf.scales.reshape((-1,) + leaf.scales.shape[2:])
        if leaf.q.ndim == 4 and _kernel_ok(leaf, x.shape[0]):
            return quant_matvec_stacked_fused(x, q, scales, flat_idx, bits=leaf.bits)
        return linear(x, replace(leaf, q=_entry(q, flat_idx), scales=_entry(scales, flat_idx)))
    return x @ _entry(leaf.reshape((-1,) + leaf.shape[2:]), flat_idx)


def _moe_ffn_decode(h: torch.Tensor, layers: Dict[str, Any], l: int,
                    config: ModelConfig) -> torch.Tensor:
    """Sparse-MoE FFN of the decode rows ``h [T, H]`` at layer ``l``: sparse
    (one call a routed (row, choice), T·K ≤ E/2) or dense over experts,
    accumulated in the JAX package's order and dtypes. Under tp the expert
    stacks are the rank's FFN columns and the result is its partial sum
    (the caller's ``all_reduce`` completes it)."""
    t = h.shape[0]
    e = config.num_experts
    _, gate_vals, idx = route(h, layers["router"][l], config)
    act = ops.activation(config.hidden_act)

    def expert_ffn(rows, flat_e):
        gate = act(_expert_linear_l(rows, layers["w1"], flat_e))
        if "w3" in layers:
            gate = gate * _expert_linear_l(rows, layers["w3"], flat_e)
        return _expert_linear_l(gate, layers["w2"], flat_e)

    if t * config.num_experts_per_tok <= e // 2:
        flat = (idx + l * e).to(torch.int32)  # [T, K] on h's device
        rows = []
        for row in range(t):
            x_row = h[row:row + 1]
            contrib = torch.zeros_like(x_row)
            for j in range(config.num_experts_per_tok):
                out = expert_ffn(x_row, flat[row, j])
                contrib = contrib + gate_vals[row, j].to(h.dtype) * out
            rows.append(contrib)
        return torch.cat(rows)
    gates = torch.zeros((t, e), dtype=torch.float32, device=h.device).scatter(
        1, idx, gate_vals)
    y = torch.zeros_like(h)
    for ex in range(e):
        y = y + gates[:, ex:ex + 1].to(h.dtype) * expert_ffn(h, l * e + ex)
    return y


def _moe_ok(params: Dict[str, Any], config: ModelConfig) -> bool:
    """MoE models take the decode path when their expert leaves are stacked
    ``[L, E, ...]`` (dense or quantized) beside a router."""
    if not config.num_experts:
        return True
    layers = params.get("layers", {})
    if "router" not in layers:
        return False

    def ok(leaf) -> bool:
        return (leaf.q if isinstance(leaf, QuantizedTensor) else leaf).ndim == 4

    return all(ok(layers[n]) for n in ("w1", "w2", "w3") if n in layers)


def supports_fast_decode(params: Dict[str, Any], cache, config: ModelConfig,
                         tokens: torch.Tensor) -> bool:
    """Whether `forward` may take `decode_step` (the JAX package's rule, its
    sharding clause aside): at most 16 tokens, one on a paged cache (the
    JAX scan route's scatter takes paged windows), and MoE leaves stacked."""
    s = tokens.shape[1]
    return (s <= DECODE_MAX_TOKENS and (s == 1 or not isinstance(cache, PagedKVCache))
            and _moe_ok(params, config))


def decode_step(params: Dict[str, Any], cache, tokens: torch.Tensor, start_pos,
                config: ModelConfig, *, ffn_block: bool = False, tp=None):
    """One decode window ``tokens [B, S]`` (S ≤ 16) at ``start_pos``; same
    contract as `forward`. The cache is updated in place. ``start_pos`` is
    an int, or an integer device tensor, 0-d (shared) or ``[B]`` (per row).
    A tensor is never read back to the host, at one token or at 2-16 (the
    cache rows of a longer window are written at indices computed on the
    device), so a window captured in a CUDA graph reads the position from
    that tensor at every replay (`engine.generate`, `engine.speculative`).
    ``ffn_block`` merges each layer's post-attention block into one kernel
    launch where `_ffn_block_ok` holds. ``tp`` (a `parallel.mesh.Mesh` of
    tp > 1): ``params`` and ``cache`` are this rank's local ones,
    ``config`` the whole model's; the module docstring's tensor-parallel
    step, its ``ffn_block`` off."""
    config, tp = tp_config(config, tp)
    if tp is not None and config.use_bias:
        raise NotImplementedError("the tp fast decode adds no biases (they would be summed "
                                  "over ranks); use_bias models take the layer route "
                                  "(forward(..., tp=mesh))")
    ffn_block = ffn_block and tp is None
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
    if paged and s > 1:
        raise ValueError("decode_step takes one token a row on a paged cache; forward "
                         "sends longer windows to the layer route")

    x = embed_tokens(params, tokens, positions, config, tp).reshape(rows, -1)
    merged = ffn_block and _ffn_block_ok(layers, rows, x.dtype, config)
    # Rope rows of the window's positions, [B, S, hd/2], gathered once a
    # step per table (Gemma-3's sliding layers take the local one).
    rope = config.position_embedding == "rope"
    rope_rows = {name: table[positions] for name, table in params["rope"].items()} \
        if rope else {}
    # The kernel's prologue is an rmsnorm: layernorm runs outside it.
    prologue = config.norm_type != "layernorm"

    def norm_linear(x_res, name: str, norm_name: str, l: int, normed: dict):
        """layers[name] @ norm(x_res): the norm inside the kernel when it
        applies, else one normed activation shared by the layer's
        projections."""
        leaf = layers[name]
        norm_w = layers[norm_name]
        if prologue and _kernel_ok(leaf, rows) and norm_w.dtype == x_res.dtype:
            return quant_matvec_stacked_fused(x_res, leaf.q, leaf.scales, l,
                                              bits=leaf.bits, norm_stack=norm_w,
                                              norm_eps=eps, norm_offset=mu)
        if norm_name not in normed:
            normed[norm_name] = norm(x_res, layers, norm_name, config, l)
        return linear_l(normed[norm_name], name, l)

    def linear_l(h, name: str, l: int):
        return _linear_l(h, layers[name], l, rows)

    def bias_l(y, name: str, l: int):
        return biased(y, layers, name, config, l)

    for l in range(config.num_layers):
        normed: dict = {}
        if "wqkv" in layers:
            q, k, v = split_qkv(bias_l(norm_linear(x, "wqkv", "attn_norm", l, normed),
                                       "wqkv_b", l), layers["wqkv"], config)
        else:
            q, k, v = (bias_l(norm_linear(x, n, "attn_norm", l, normed), n + "_b", l)
                       for n in ("wq", "wk", "wv"))
        q, k = q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd)
        if config.use_qk_norm:
            q = rms_norm(q, layers["q_norm"][l], config)
            k = rms_norm(k, layers["k_norm"][l], config)
        if rope:
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
            if quantized:
                update_stacked_layer_cache_quantized(
                    cache.k, cache.v, cache.k_scale, cache.v_scale, k, v, l, start_pos)
                keys = dequantize_kv(cache.k[l], cache.k_scale[l], x.dtype)
                values = dequantize_kv(cache.v[l], cache.v_scale[l], x.dtype)
            else:
                update_stacked_layer_cache(cache.k, cache.v, k, v, l, start_pos)
                keys, values = cache.k[l], cache.v[l]
            mask = ops.causal_mask(positions, cache.k.shape[3], lengths[:, None, None],
                                   None if window < 0 else window)
            attn = ops.attention(q, keys, values, mask, scale=scale)
        attn = attn.reshape(rows, nh * hd)
        if merged:
            x = fb.ffn_block_stacked(
                attn.contiguous(), x, layers["wo"].q, layers["wo"].scales, layers["ffn_norm"],
                layers["w13"].q, layers["w13"].scales, layers["w2"].q, layers["w2"].scales,
                l, bits=layers["wo"].bits, act=config.hidden_act, eps=eps, offset=mu)
            continue
        attn = bias_l(linear_l(attn, "wo", l), "wo_b", l)
        if tp is not None:  # row-parallel wo: sum the partial outputs
            attn = tp.all_reduce(attn)
        if config.use_post_norms:
            attn = rms_norm(attn, layers["post_attn_norm"][l], config)
        x = x + attn

        normed = {}
        act = ops.activation(config.hidden_act)
        if config.num_experts:
            ffn = _moe_ffn_decode(norm(x, layers, "ffn_norm", config, l), layers, l, config)
        elif "w13" in layers:
            fused = bias_l(norm_linear(x, "w13", "ffn_norm", l, normed), "w13_b", l)
            ffn = linear_l(act_gate(fused, config.hidden_act,
                                    getattr(layers["w13"], "fuse_tp", 1)), "w2", l)
        elif config.ffn_type == "mlp":
            gate = act(bias_l(norm_linear(x, "w1", "ffn_norm", l, normed), "w1_b", l))
            ffn = bias_l(linear_l(gate, "w2", l), "w2_b", l)
        else:
            gate = act(norm_linear(x, "w1", "ffn_norm", l, normed))
            ffn = linear_l(gate * norm_linear(x, "w3", "ffn_norm", l, normed), "w2", l)
        if tp is not None:  # row-parallel w2
            ffn = tp.all_reduce(ffn)
        if config.use_post_norms:
            ffn = rms_norm(ffn, layers["post_ffn_norm"][l], config)
        x = x + ffn

    x = norm(x, params, "final_norm", config)
    lm_head = params["lm_head"]
    if isinstance(lm_head, QuantizedTensor) and lm_head.q.ndim == 2 \
            and _kernel_ok(lm_head, rows):
        logits = quant_matvec_stacked_fused(x, lm_head.q[None], lm_head.scales[None],
                                            0, bits=lm_head.bits)
    else:
        logits = linear(x, lm_head)
    logits = logits.float()
    if tp is not None:  # the rank's vocabulary columns → the whole logits
        logits = tp.all_gather(logits, dim=-1)
    return logits.reshape(b, s, -1), cache
