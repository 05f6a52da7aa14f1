"""Decoder-only transformer, Llama, Gemma-3, Mixtral and GPT-2: the
layer-by-layer route (port of the JAX package's ``models/transformer.py``).

Parameter tree (same keys and layouts as the JAX package; per-layer leaves
stacked on a leading layer axis):

  params = {
    "embed": [V, H],
    "layers": {"attn_norm": [L, H], "wqkv" | "wq"/"wk"/"wv", "wo",
               "ffn_norm": [L, H], "w13" | "w1"/"w3", "w2",
               Gemma-3 only: "q_norm", "k_norm": [L, hd],
               "post_attn_norm", "post_ffn_norm": [L, H],
               Mixtral: "router": [L, H, E] and expert stacks
               "w1"/"w3": [L, E, H, F], "w2": [L, E, F, H];
               GPT-2: no "w3", layernorm biases "attn_norm_b",
               "ffn_norm_b": [L, H] and projection biases "<name>_b":
               [L, out] ("wqkv_b" once fused)},
    "final_norm": [H], "lm_head": [H, V] or QuantizedTensor,
    GPT-2 also "final_norm_b": [H] and "pos_emb": [S_max, H],
    "rope": {"cos", "sin": [S_max, hd/2]; Gemma-3 also
             "cos_local", "sin_local" at rope_local_theta},
  }

Dense linear leaves are ``[L, in, out]``; quantized ones are
``QuantizedTensor`` (act8: ``q [L, out, in/2]``, scales ``[L, 1, out]``;
weight-only: either orientation, group scales); LoRA ones are
``LoraLinear`` (a base of either kind, adaptors ``a [L, in, r]``,
``b [L, r, out]``), which `linear` runs on the layer route.
The layer loop is a Python loop over views of the stacked leaves. Gemma-3's
extras follow the config: every norm's weight is ``norm_weight_offset + w``,
q/k norms over hd, post-attention and post-FFN norms, the embedding scale,
gelu-tanh, ``query_scale``, and sliding layers (``config.layer_window``)
with their own rope table. Mixtral's FFN is ``models/moe.moe_ffn``.
GPT-2's switches follow the config too: layernorm (``norm_type``), learned
positions added to the embedding in place of rope (``position_embedding``;
the ``pos_emb`` gather clamps its index to the last row, as JAX's gather
does), bias adds after the projections (``use_bias``) and the biased gelu
MLP (``ffn_type == "mlp"``).

`forward` sends windows of up to 16 tokens to ``models/decode.decode_step``
where `supports_fast_decode` allows it, as the JAX package does; everything
else takes `_layer_step` layer by layer, the JAX package's scan route. At
one token that route writes the cache first (the JAX package's XLA-side
write), then attends with the one-layer read-only kernels, as JAX does
under its block conditions: a dense cache whose length a block of 128 or
256 divides takes ``decode_attention(_quantized)``, a paged cache with pages
of 128 or 256 ``paged_decode_attention``; otherwise, and for 2-16 tokens,
the reference attention under a causal mask; longer windows flash attention.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

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
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.models.fuse import split_fused
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.ops.decode_attention import decode_attention, decode_attention_quantized
from metalchat_tpu_torch.ops.flash_attention import flash_attention
from metalchat_tpu_torch.ops.paged_attention import paged_decode_attention
from metalchat_tpu_torch.quant.quantize import (
    LoraLinear,
    QuantizedTensor,
    linear,
    linear_row_parallel,
    lookup_embedding,
)

Params = Dict[str, Any]
Cache = Union[KVCache, QuantizedKVCache, PagedKVCache]

# Windows of at most this many tokens take the decode path (as in the JAX
# package: weights are read once per window through the matvec kernel).
DECODE_MAX_TOKENS = 16


MOE_LEAVES = ("router", "w1", "w3", "w2")


def _choose_block(length: int, preferred: int = 256) -> Optional[int]:
    """The JAX package's block rule: the largest of 256 and 128 that divides
    ``length`` (None: its one-token scan route takes no kernel)."""
    for candidate in (preferred, 128):
        if candidate <= length and length % candidate == 0:
            return candidate
    return None


def layer_leaf(leaf, l: int):
    """Layer ``l`` of a stacked linear leaf: dense, quantized or LoRA (views,
    no copy)."""
    return leaf.layer(l) if isinstance(leaf, (QuantizedTensor, LoraLinear)) else leaf[l]


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


def rms_norm(x: torch.Tensor, w: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """rmsnorm with the config's eps and weight offset (Gemma-3's q/k and
    post norms, whatever ``norm_type`` says)."""
    return ops.rms_norm(x, w, eps=config.rms_norm_eps, offset=config.norm_weight_offset)


def _leaf(tree: Params, name: str, l: Optional[int]):
    return tree[name] if l is None else tree[name][l]


def norm(x: torch.Tensor, tree: Params, name: str, config: ModelConfig,
         l: Optional[int] = None) -> torch.Tensor:
    """The pre-norm ``tree[name]`` (layer ``l`` of a stacked leaf): rmsnorm,
    or with ``norm_type == "layernorm"`` layernorm with the bias leaf
    ``<name>_b``."""
    w = _leaf(tree, name, l)
    if config.norm_type == "layernorm":
        return ops.layer_norm(x, w, _leaf(tree, name + "_b", l), eps=config.rms_norm_eps)
    return rms_norm(x, w, config)


def biased(y: torch.Tensor, tree: Params, name: str, config: ModelConfig,
           l: Optional[int] = None) -> torch.Tensor:
    """``y + tree[name]`` (layer ``l``) where the config has biases and the
    tree the leaf: added in y's dtype after the product, as JAX adds."""
    if config.use_bias and name in tree:
        return y + _leaf(tree, name, l)
    return y


def _tp_lookup_embedding(tokens: torch.Tensor, embed, mesh) -> torch.Tensor:
    """Lookup in a vocabulary-split embedding: the rank at tp place i holds
    rows ``[i·V_l, (i+1)·V_l)``; an id outside them reads row 0 and is
    zeroed, then one ``all_reduce`` over tp assembles the rows (exact: one
    rank adds each value to zeros), in the lookup's dtype, as JAX's
    ``psum``."""
    v_local = (embed.q if isinstance(embed, QuantizedTensor) else embed).shape[0]
    local = tokens - mesh.index("tp") * v_local
    valid = (local >= 0) & (local < v_local)
    x = lookup_embedding(local.clamp(0, v_local - 1), embed)
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return mesh.all_reduce(x)


def embed_tokens(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
                 config: ModelConfig, tp=None) -> torch.Tensor:
    """Token embedding in the activation dtype (that of ``final_norm``),
    times ``embedding_scale`` rounded to that dtype first, as the JAX
    package multiplies; with learned positions plus ``pos_emb[positions]``.
    The position index is clamped to the table's last row on the device (a
    padded prompt chunk or an idle engine row may run past it: JAX's gather
    clamps, and on the card an index past the table is a device assert).
    Under ``tp`` (a `parallel.mesh.Mesh`) the table is this rank's
    vocabulary rows (`_tp_lookup_embedding`); on the differentiable route a
    whole table is looked up on every rank, so that each holds its whole
    gradient."""
    embed = params["embed"]
    whole = (embed.q if isinstance(embed, QuantizedTensor) else embed).shape[0] \
        == config.vocab_size
    if tp is None or tp.differentiable and whole:
        lookup = lookup_embedding(tokens, embed)
    else:
        lookup = _tp_lookup_embedding(tokens, embed, tp)
    x = lookup.to(params["final_norm"].dtype)
    if config.embedding_scale is not None:
        x = x * torch.tensor(config.embedding_scale, dtype=x.dtype).item()
    if config.position_embedding == "learned":
        table = params["pos_emb"]
        x = x + table[positions.clamp_max(table.shape[0] - 1)].to(x.dtype)
    return x


def final_logits(params: Params, x: torch.Tensor, config: ModelConfig, *,
                 kernels: bool = True, tp=None) -> torch.Tensor:
    """Final norm + lm head → f32 logits; under ``tp`` a vocabulary-split
    lm_head gives this rank's columns and the whole logits are gathered (a
    whole lm_head, kept so when tp does not divide the vocabulary, gives
    them all on every rank)."""
    head = params["lm_head"]
    h = norm(x, params, "final_norm", config)
    base = head.base if isinstance(head, LoraLinear) else head
    split = tp is not None and (base.out_features if isinstance(base, QuantizedTensor)
                                else base.shape[-1]) != config.vocab_size
    if split:
        h = tp.sum_grad(h)
    logits = linear(h, head, kernels=kernels, tp=tp if split else None).float()
    return tp.all_gather(logits, dim=-1) if split else logits


def act_gate(fused: torch.Tensor, act: str = "silu", blocks: int = 1) -> torch.Tensor:
    """``act(gate) * up`` of a fused w13 output ``[.., 2F]`` (``blocks``:
    the leaf's ``fuse_tp``, `models.fuse.split_fused`)."""
    f = fused.shape[-1] // 2
    gate, up = split_fused(fused, (f, f), blocks)
    return ops.activation(act)(gate) * up


def split_qkv(y: torch.Tensor, leaf, config: ModelConfig):
    """q, k, v of a fused wqkv output (``leaf``'s ``fuse_tp`` blocking)."""
    hd = config.head_dim
    return split_fused(y, (config.num_heads * hd, config.num_kv_heads * hd,
                           config.num_kv_heads * hd), getattr(leaf, "fuse_tp", 1))


def tp_config(config: ModelConfig, tp):
    """(the config of this rank's shard, the mesh) under tensor parallelism,
    (config, None) without it or at tp 1."""
    if tp is None or tp.tp == 1:
        return config, None
    from metalchat_tpu_torch.parallel.tp_decode import _local_config

    return _local_config(config, tp.tp), tp


def _paged_layer(cache: PagedKVCache, l: int, heads=None):
    """Layer ``l``'s pages and scales (views; with ``heads``, the kv-heads
    that `pick_heads` keeps, copies)."""
    pages = tuple(t[l] for t in (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale))
    if heads is None:
        return pages
    return tuple(pick_heads(t, heads, dim) for t, dim in zip(pages, (0, 0, 1, 1)))


def pick_heads(t: torch.Tensor, heads, dim: int = 1) -> torch.Tensor:
    """The kv-heads (axis ``dim`` of ``t``) that a rank's query heads read,
    ``heads`` being `parallel.tp_decode.rank_kv_heads` (None: all of them):
    where its query heads fall into whole groups of the kv-heads they read
    (CFG at tp 4: one head over one kv-head; Gemma-3-1B at tp 2: two over
    one), those kv-heads in order, so the attention sees whole GQA groups;
    otherwise one kv-head for each query head. A copy (contiguous) unless
    every kv-head is kept."""
    if heads is None:
        return t
    lo, n, local = heads[0], heads[-1] - heads[0] + 1, len(heads)
    if local % n == 0 and list(heads) == [lo + j // (local // n) for j in range(local)]:
        return t if n == t.shape[dim] else t.narrow(dim, lo, n).contiguous()
    return t.index_select(dim, torch.tensor(heads, device=t.device))


def _attend_one(q, cache: Cache, l: int, offsets, config: ModelConfig,
                window: Optional[int] = None, heads=None):
    """The one-token scan route's attention kernels (rows 6 and 7) over
    layer ``l`` of the cache, already written, with the model layer's
    ``window`` (default layer ``l``'s) and the kv-heads ``heads`` keeps
    (`pick_heads`); None where the JAX block conditions leave the step to
    the reference attention."""
    lengths = (offsets + 1).to(torch.int32)
    kw = dict(scale=config.attention_scale(),
              window=config.layer_window(l) if window is None else window)
    q1 = q[:, 0].contiguous()
    if isinstance(cache, PagedKVCache):
        if _choose_block(cache.page_size) != cache.page_size:
            return None
        return paged_decode_attention(q1, *_paged_layer(cache, l, heads), cache.page_table,
                                      lengths, **kw)[:, None]
    if _choose_block(cache.k.shape[3]) is None:
        return None
    k, v = pick_heads(cache.k[l], heads), pick_heads(cache.v[l], heads)
    if isinstance(cache, QuantizedKVCache):
        return decode_attention_quantized(q1, k, v, pick_heads(cache.k_scale[l], heads),
                                          pick_heads(cache.v_scale[l], heads), lengths,
                                          **kw)[:, None]
    return decode_attention(q1, k, v, lengths, **kw)[:, None]


def attention_inputs(x, layers: Params, l: int, config: ModelConfig, rope, positions,
                     lin=linear, layer_id: Optional[int] = None, tp=None,
                     kv_whole: bool = False):
    """Layer ``l``'s q ``[B, S, nh, hd]``, k and v ``[B, S, nkv, hd]`` of
    ``x``: the pre-norm, the projections (fused or not, with their biases),
    Gemma-3's q/k norms and rope at ``positions`` with the table of model
    layer ``layer_id`` (default ``l``). ``lin`` runs the products.

    Under ``tp`` (config: the rank's shard) the whole normed input enters
    the column-parallel products through ``tp.sum_grad``, and so do the
    q/k norm weights that the rank applies to its own heads only, so that
    each whole leaf's and activation's gradient is summed over tp on the
    differentiable route (the identity on the inference route). With
    ``kv_whole`` (kv-heads that tp does not divide) wk and wv are whole and
    take the input itself (`_layer_step` sums k's and v's gradients)."""
    layer_id = l if layer_id is None else layer_id
    b, s, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim
    grad = (lambda t: t) if tp is None else tp.sum_grad
    col = lin if tp is None else functools.partial(lin, tp=tp)
    h = norm(x, layers, "attn_norm", config, l)
    cols = grad(h)
    if "wqkv" in layers:
        if kv_whole and tp.differentiable:
            raise ValueError("a fused wqkv with kv-heads that tp does not divide mixes split "
                             "q with whole k and v columns: train the unfused tree")
        q, k, v = split_qkv(biased(col(cols, layer_leaf(layers["wqkv"], l)), layers, "wqkv_b",
                                   config, l), layers["wqkv"], config)
    else:
        q = biased(col(cols, layer_leaf(layers["wq"], l)), layers, "wq_b", config, l)
        k, v = (biased(lin(h, layer_leaf(layers[n], l)) if kv_whole
                       else col(cols, layer_leaf(layers[n], l)), layers, n + "_b", config, l)
                for n in ("wk", "wv"))
    q, k = q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd)
    if config.use_qk_norm:
        q = rms_norm(q, grad(layers["q_norm"][l]), config)
        k = rms_norm(k, layers["k_norm"][l] if kv_whole else grad(layers["k_norm"][l]),
                     config)
    if config.position_embedding == "rope":
        cos, sin = layer_rope(rope, config, layer_id)
        q = ops.apply_rope(q, cos, sin, positions)
        k = ops.apply_rope(k, cos, sin, positions)
    return q, k, v.reshape(b, s, nkv, hd)


def attention_residual(x, attn, layers: Params, l: int, config: ModelConfig, row=linear):
    """``x`` plus layer ``l``'s output projection of ``attn [B, S, nh,
    hd]`` (with its bias and Gemma-3's post-norm); ``row`` runs wo."""
    b, s = attn.shape[:2]
    out = biased(row(attn.reshape(b, s, -1), layer_leaf(layers["wo"], l)),
                 layers, "wo_b", config, l)
    if config.use_post_norms:
        out = rms_norm(out, layers["post_attn_norm"][l], config)
    return x + out


def ffn_residual(x, layers: Params, l: int, config: ModelConfig, lin=linear, row=linear,
                 kernels: bool = True, moe_mesh=None, tp=None):
    """``x`` plus layer ``l``'s feed-forward block of its pre-norm (MoE,
    fused w13, GPT-2's MLP or SwiGLU; Gemma-3's post-norm), and the MoE
    load-balancing loss (None on a dense layer). ``row`` runs w2; MoE runs
    on ``moe_mesh``'s experts and FFN width (`models.moe.moe_ffn`: the
    router whole on every rank, the experts' input summing its gradient
    over tp and ep there). Under ``tp`` a dense block's normed input enters
    the column-parallel products through ``tp.sum_grad``
    (`attention_inputs`)."""
    h = norm(x, layers, "ffn_norm", config, l)
    if tp is not None and not config.num_experts:
        h, lin = tp.sum_grad(h), functools.partial(lin, tp=tp)
    aux = None
    if config.num_experts:
        from metalchat_tpu_torch.models.moe import moe_ffn

        ffn, aux = moe_ffn(h, {n: layer_leaf(layers[n], l) for n in MOE_LEAVES if n in layers},
                           config, kernels=kernels, mesh=moe_mesh)
    elif "w13" in layers:
        fused = biased(lin(h, layer_leaf(layers["w13"], l)), layers, "w13_b", config, l)
        ffn = row(act_gate(fused, config.hidden_act, getattr(layers["w13"], "fuse_tp", 1)),
                  layer_leaf(layers["w2"], l))
    elif config.ffn_type == "mlp":
        gate = ops.activation(config.hidden_act)(
            biased(lin(h, layer_leaf(layers["w1"], l)), layers, "w1_b", config, l))
        ffn = biased(row(gate, layer_leaf(layers["w2"], l)), layers, "w2_b", config, l)
    else:
        w2 = layer_leaf(layers["w2"], l)
        ffn = ops.swiglu(h, layer_leaf(layers["w1"], l), layer_leaf(layers["w3"], l), w2,
                         config.hidden_act,
                         matmul=lambda a, w: row(a, w) if w is w2 else lin(a, w))
    if config.use_post_norms:
        ffn = rms_norm(ffn, layers["post_ffn_norm"][l], config)
    return x + ffn, aux


def _layer_step(x, layers: Params, l: int, cache: Cache, config: ModelConfig,
                rope, positions, offsets, start_pos, kv_end: int, paged_at=None,
                differentiable: bool = False, tp=None, layer_id: Optional[int] = None,
                moe_mesh=None, kv_heads=None):
    """One layer: (x after it, the layer's MoE load-balancing loss or None
    on a dense layer). ``l`` indexes the stacked leaves and the cache,
    ``layer_id`` (default ``l``) is the layer's place in the model, which
    picks its window and rope table. Under ``tp`` (config: the rank's
    shard) wo and w2 are row-parallel (`linear_row_parallel`); MoE runs on
    ``moe_mesh``'s experts; with ``kv_heads`` (`parallel.tp_decode.
    rank_kv_heads`) the kv-heads are whole, written whole into the cache,
    and the attention reads those the rank's query heads read
    (`pick_heads`)."""
    layer_id = l if layer_id is None else layer_id
    s = x.shape[1]
    kernels = not differentiable
    lin = functools.partial(linear, kernels=kernels)
    row = lin if tp is None else functools.partial(linear_row_parallel, mesh=tp,
                                                   kernels=kernels)
    q, k, v = attention_inputs(x, layers, l, config, rope, positions, lin, layer_id, tp,
                               kv_heads is not None)
    pick = functools.partial(pick_heads, heads=kv_heads)

    paged = isinstance(cache, PagedKVCache)
    window = config.layer_window(layer_id)
    attn = None
    if differentiable:
        keys, values = _differentiable_kv(cache, l, k, v, start_pos)
        cache_dtype = values.dtype
        if kv_heads is not None:
            # Whole kv-heads, each rank's queries reading some: their f32
            # gradients summed over tp before the cache dtype's rounding,
            # which the single device applies once to the whole sum.
            keys, values = tp.sum_grad(keys.float()), tp.sum_grad(values.float())
        keys, values = pick(keys), pick(values)
        mask = ops.causal_mask(positions, keys.shape[2], (offsets + s)[:, None, None],
                               None if window < 0 else window)
        attn = ops.attention(q, keys, values, mask, scale=config.attention_scale(),
                             weights_dtype=cache_dtype)
    elif paged:
        write_paged_layer(*_paged_layer(cache, l), k, v, *paged_at)
    elif isinstance(cache, QuantizedKVCache):
        update_layer_cache_quantized(cache.k[l], cache.v[l], cache.k_scale[l],
                                     cache.v_scale[l], k, v, start_pos)
    else:
        update_layer_cache(cache.k[l], cache.v[l], k, v, start_pos)
    if s == 1 and attn is None:
        attn = _attend_one(q, cache, l, offsets, config, window, kv_heads)
    if attn is None:
        if paged:  # each row's whole page table, gathered and dequantized
            kp, vp, ksc, vsc = _paged_layer(cache, l)
            pt = cache.page_table
            keys = dequantize_kv(gather_pages_dense(kp, pt), gather_page_scales(ksc, pt),
                                 x.dtype)
            values = dequantize_kv(gather_pages_dense(vp, pt), gather_page_scales(vsc, pt),
                                   x.dtype)
        elif isinstance(cache, QuantizedKVCache):
            # The cache up to the window's end, dequantized to the activation dtype.
            keys = dequantize_kv(cache.k[l][:, :, :kv_end], cache.k_scale[l][:, :, :kv_end],
                                 x.dtype)
            values = dequantize_kv(cache.v[l][:, :, :kv_end], cache.v_scale[l][:, :, :kv_end],
                                   x.dtype)
        else:
            keys = cache.k[l][:, :, :kv_end].contiguous()
            values = cache.v[l][:, :, :kv_end].contiguous()
        keys, values = pick(keys), pick(values)
        if s > DECODE_MAX_TOKENS:
            attn = flash_attention(q.contiguous(), keys, values, start_pos,
                                   scale=config.attention_scale(), window=window)
        else:
            mask = ops.causal_mask(positions, keys.shape[2], (offsets + s)[:, None, None],
                                   None if window < 0 else window)
            attn = ops.attention(q, keys, values, mask, scale=config.attention_scale())
    x = attention_residual(x, attn, layers, l, config, row)
    return ffn_residual(x, layers, l, config, lin, row, kernels, moe_mesh, tp)


def layer_inputs(tokens: torch.Tensor, start_pos, cache: Cache) -> Dict[str, Any]:
    """`run_layers`' position arguments for ``tokens [B, S]`` written at
    ``start_pos`` (an int, or an integer tensor: 0-d, or ``[B]`` per-row
    offsets): ``start_pos`` (an int where it was not per row), ``offsets``
    ``[B]``, ``positions`` ``[B, S]``, ``kv_end`` (the end of the cache that
    a dense window reads; a per-row window reads its ends back to the host)
    and a paged cache's ``paged_at``."""
    b, s = tokens.shape
    paged = isinstance(cache, PagedKVCache)
    if torch.is_tensor(start_pos) and start_pos.ndim == 1:
        offsets = start_pos.to(device=tokens.device, dtype=torch.int64)
        # A paged cache is read through whole page tables: no host read of the ends.
        kv_end = 0 if paged else int(offsets.max()) + s
    else:
        start_pos = int(start_pos)
        offsets = torch.full((b,), start_pos, dtype=torch.int64, device=tokens.device)
        kv_end = start_pos + s
    positions = offsets[:, None] + torch.arange(s, device=tokens.device)[None, :]
    paged_at = positions_to_pages(cache.page_table, positions, cache.page_size) \
        if paged else None
    return dict(start_pos=start_pos, offsets=offsets, positions=positions, kv_end=kv_end,
                paged_at=paged_at)


def run_layers(x: torch.Tensor, layers: Params, cache: Cache, *, config: ModelConfig,
               rope, positions, offsets, start_pos, kv_end: int, paged_at=None,
               first_layer: int = 0, remat: bool = False, differentiable: bool = False,
               tp=None, moe_mesh=None, kv_heads=None):
    """Run a stack of layers over ``x`` (the JAX package's ``run_layers``,
    the layer loop that `forward` and a pipeline stage share): ``layers``'
    stacked leaves ``[L_local, ...]`` and the matching layers of ``cache``,
    written in place, one `_layer_step` each. Local layer ``l`` is layer
    ``first_layer + l`` of the model, which picks its window and rope
    table. ``tp``, ``moe_mesh`` and ``kv_heads`` are `_layer_step`'s.
    Returns (x, the MoE layers' load-balancing losses, a list)."""
    aux = []
    for l in range(layers["attn_norm"].shape[0]):
        step = functools.partial(_layer_step, layers=layers, l=l, cache=cache, config=config,
                                 rope=rope, positions=positions, offsets=offsets,
                                 start_pos=start_pos, kv_end=kv_end, paged_at=paged_at,
                                 differentiable=differentiable, tp=tp,
                                 layer_id=first_layer + l, moe_mesh=moe_mesh,
                                 kv_heads=kv_heads)
        x, layer_aux = checkpoint(step, x, use_reentrant=False) if remat else step(x)
        if layer_aux is not None:
            aux.append(layer_aux)
    return x, aux


def _differentiable_kv(cache: Cache, l: int, k, v, start_pos):
    """The differentiable route's keys and values for layer ``l``: the
    cache's earlier rows, then k and v cast to the cache's dtype, the JAX
    package's XLA route (its cache write rounds them so, and the gradient
    passes the cast). The cache is written too, outside the graph: autograd
    never sees an in-place write into the shared ``[L, ...]`` cache, which a
    layer recomputed under ``remat`` would trip on."""
    if not isinstance(cache, KVCache) or torch.is_tensor(start_pos) and start_pos.ndim:
        raise ValueError("forward(differentiable=True) takes a dense KVCache and one "
                         "start position for every row")
    start = int(start_pos)
    with torch.no_grad():
        update_layer_cache(cache.k[l], cache.v[l], k.detach(), v.detach(), start)
    kv = [t.transpose(1, 2).to(cache.k.dtype) for t in (k, v)]
    if start:
        kv = [torch.cat([c[l][:, :, :start], t], dim=2) for c, t in zip((cache.k, cache.v), kv)]
    return kv


def forward(params: Params, cache: Cache, tokens: torch.Tensor, start_pos,
            config: ModelConfig, *, remat: bool = False, with_aux: bool = False,
            fast_decode: bool = True, differentiable: bool = False,
            ffn_block: bool = False, tp=None):
    """One model step: tokens int ``[B, S]`` written at ``start_pos`` (an int,
    or an integer tensor: 0-d, or ``[B]`` per-row offsets). Returns (f32
    logits ``[B, S, V]``, cache), the cache updated in place, and with
    ``with_aux`` a third value: the mean over layers of MoE's load-balancing
    loss (an f32 0-d tensor, exactly 0 for a dense model).

    With ``fast_decode`` (the default), windows that `supports_fast_decode`
    accepts (up to 16 tokens; one on a paged cache; MoE experts stacked
    ``[L, E, ...]``) take `decode_step` (the matvec kernel path), which
    reads a tensor ``start_pos`` on the device only. Every other call, and
    every call with ``fast_decode=False``, ``remat`` or ``differentiable``,
    takes the layer-by-layer route (the module docstring). ``ffn_block`` is
    `decode_step`'s: the merged post-attention kernel on decode windows (the
    other route is not affected).

    ``differentiable=True`` is the training route, the JAX package's
    ``allow_pallas=False``: no kernel runs (none defines a backward), the
    quantized products take `quant_matmul` and attention the reference
    version under a causal mask at every length, over k and v rounded to
    the cache's dtype (a dense `KVCache`, one start position). ``remat=True``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).

    ``tp`` (a `parallel.mesh.Mesh` of tp > 1 or ep > 1) is the sharded
    layer route, JAX's GSPMD forward on sharded params: ``params`` and
    ``cache`` are this rank's local ones (`parallel.mesh.shard_params`,
    `shard_cache`), ``config`` the whole model's. Every window, one token
    included, takes the layer route at the rank's heads; kv-heads that tp
    does not divide are whole on every rank and each rank attends over
    those its query heads read (`pick_heads`). With ``differentiable``
    the route runs on the mesh's differentiable view (`parallel.mesh.
    DifferentiableMesh`): every rank's gradients are those of its leaves
    under the single device's loss (a whole leaf's the whole gradient on
    every rank), `remat` recomputing each layer's collectives in the
    backward pass on every rank alike. There MoE runs its experts over ep
    and tp with their gradients, and on a mesh with dp > 1 (any ep and tp)
    routes the whole batch as the JAX package's one program does
    (`models.moe`): ``tokens`` are then this dp row's rows, and the third
    value ``with_aux`` returns is this dp row's share of the whole batch's
    load-balancing loss (the shares sum over dp to it). A `LoraLinear` on
    an expert stack is refused on every route, naming the leaf (the JAX
    package's MoE fails on it). Without experts
    over ep the result is the single device's function for every leaf
    kind: the embedding split by vocabulary (or whole), wo and w2
    row-parallel (`linear_row_parallel`: act8 codes from the whole row and
    exact int32 sums; weight-only, dense and LoRA products summed in f32,
    rounded once), a column-parallel leaf's local bias added after its
    product and a row-parallel one's whole bias after the sum, the lm_head
    split by vocabulary (or whole) and the whole logits on every rank. MoE
    runs the rank's
    experts at its FFN width and sums them over ep
    (`models.moe.moe_ffn`), whose order is not the single device's.
    `parallel.tp_decode.tp_decode_forward_fn` sends one-token steps to
    `decode_step(..., tp=)` where the fast decode takes the mesh, as in
    JAX."""
    from metalchat_tpu_torch.models.decode import decode_step, supports_fast_decode
    from metalchat_tpu_torch.parallel.tp_decode import rank_kv_heads

    if config.num_experts:
        from metalchat_tpu_torch.models.moe import refuse_lora_experts

        refuse_lora_experts(n for n in ("w1", "w3", "w2")
                            if isinstance(params["layers"].get(n), LoraLinear))
    mesh = tp
    sharded = mesh is not None and (mesh.tp > 1 or mesh.ep > 1)
    if mesh is not None and differentiable:
        mesh = mesh.differentiable_view()
    # MoE on the train step's mesh routes the whole batch over dp (models.moe)
    moe_mesh = mesh if sharded or differentiable and mesh is not None and mesh.dp > 1 else None
    kv_heads = rank_kv_heads(config, mesh if sharded else None)
    config, tp = tp_config(config, mesh)
    if not sharded and fast_decode and not remat and not differentiable \
            and supports_fast_decode(params, cache, config, tokens):
        logits, cache = decode_step(params, cache, tokens, start_pos, config,
                                    ffn_block=ffn_block)
        if with_aux:
            return logits, cache, torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, cache
    where = layer_inputs(tokens, start_pos, cache)
    x = embed_tokens(params, tokens, where["positions"], config, tp)
    x, aux = run_layers(x, params["layers"], cache, config=config, rope=params["rope"],
                        remat=remat, differentiable=differentiable, tp=tp,
                        moe_mesh=moe_mesh, kv_heads=kv_heads, **where)
    logits = final_logits(params, x, config, kernels=not differentiable, tp=tp)
    if with_aux:  # the mean over layers: a dense layer adds 0
        mean = torch.stack(aux).sum() / config.num_layers if aux \
            else torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, cache, mean
    return logits, cache


def init_random_params(config: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                       max_seq_len: Optional[int] = None, device=None) -> Params:
    """Random dense parameters (tests and benchmarks without weights): the
    JAX package's ``init_random_params`` tree, N(0, 0.02) projections (and,
    for MoE, the router and ``[L, E, in, out]`` expert stacks) and unit
    norms, drawn from a ``torch.Generator`` seeded with ``seed``. GPT-2's
    leaves as in JAX: no w3 for the MLP, zero norm and projection biases,
    ``final_norm_b``, and N(0, 0.02) ``pos_emb`` of ``max_seq_len or
    config.max_seq_len`` rows."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, f = config.hidden_size, config.intermediate_size
    nh, nkv, hd, L = config.num_heads, config.num_kv_heads, config.head_dim, config.num_layers

    def dense(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = {
        "attn_norm": ones(L, h), "ffn_norm": ones(L, h),
        "wq": dense(L, h, nh * hd), "wk": dense(L, h, nkv * hd),
        "wv": dense(L, h, nkv * hd), "wo": dense(L, nh * hd, h),
    }
    if config.num_experts:
        e = config.num_experts
        layers.update(router=dense(L, h, e), w1=dense(L, e, h, f), w3=dense(L, e, h, f),
                      w2=dense(L, e, f, h))
    else:
        layers["w1"] = dense(L, h, f)
        if config.ffn_type != "mlp":
            layers["w3"] = dense(L, h, f)
        layers["w2"] = dense(L, f, h)
    if config.use_qk_norm:
        layers.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
    if config.use_post_norms:
        layers.update(post_attn_norm=ones(L, h), post_ffn_norm=ones(L, h))
    if config.norm_type == "layernorm":
        layers.update(attn_norm_b=zeros(L, h), ffn_norm_b=zeros(L, h))
    if config.use_bias:
        layers.update(wq_b=zeros(L, nh * hd), wk_b=zeros(L, nkv * hd),
                      wv_b=zeros(L, nkv * hd), wo_b=zeros(L, h), w1_b=zeros(L, f),
                      w2_b=zeros(L, h))
    embed = dense(config.vocab_size, h)
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": ones(h),
        "lm_head": embed.T if config.tie_word_embeddings else dense(h, config.vocab_size),
        "rope": make_rope_tables(config, max_seq_len, device=dev),
    }
    if config.norm_type == "layernorm":
        params["final_norm_b"] = zeros(h)
    if config.position_embedding == "learned":
        params["pos_emb"] = dense(max_seq_len or config.max_seq_len, h)
    return params
