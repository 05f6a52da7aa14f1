"""Projection fusion: wq/wk/wv → ``wqkv`` and w1/w3 → ``w13`` (port of the
JAX package's ``models/fuse.py``).

Concatenating along out-features is exact: for quantized leaves the packed
bytes and scales concatenate unchanged (groups run along in-features). Fewer,
wider matvecs mean fewer kernel launches per layer.

For tensor parallelism `permute_fused_tp` block-permutes a fused leaf's out
axis (``QuantizedTensor.fuse_tp``) so that each rank's contiguous chunk is a
standard fused leaf of its own heads and FFN columns; `split_fused` with
``blocks`` splits such an output back into its segments.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Sequence

import numpy as np
import torch

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.quant.quantize import (
    LoraLinear,
    QuantizedTensor,
    auto_orient,
    with_orientation,
)


def fused_segments(name: str, config: ModelConfig) -> tuple:
    """Logical out-axis segment widths of a fused projection leaf."""
    if name == "wqkv":
        hd = config.head_dim
        return (config.num_heads * hd, config.num_kv_heads * hd,
                config.num_kv_heads * hd)
    if name == "w13":
        return (config.intermediate_size, config.intermediate_size)
    raise ValueError(f"not a fused leaf: {name}")


def split_fused(y: torch.Tensor, segments: Sequence[int], blocks: int = 1):
    """Split a fused projection output back into its segments: views of the
    plain concatenation at ``blocks`` 1; with ``blocks`` > 1 (the
    ``fuse_tp`` layout: ``blocks`` chunks of [seg0/b | seg1/b | ...]) each
    segment's strips gathered from the chunks."""
    if blocks == 1:
        return torch.split(y, list(segments), dim=-1)
    total = y.shape[-1]
    if total != sum(segments):
        raise ValueError(f"fused width {total} != sum of segments {tuple(segments)}")
    parts = torch.split(y.reshape(*y.shape[:-1], blocks, total // blocks),
                        [s // blocks for s in segments], dim=-1)
    return [p.reshape(*y.shape[:-1], s) for p, s in zip(parts, segments)]


def _blocked_order(segments: Sequence[int], blocks: int) -> np.ndarray:
    """Index order turning [seg0|seg1|...] into ``blocks`` chunks of
    [seg0_i|seg1_i|...] (the ``fuse_tp`` layout)."""
    starts = np.concatenate([[0], np.cumsum(segments)[:-1]])
    order = []
    for i in range(blocks):
        for seg, start in zip(segments, starts):
            w = seg // blocks
            order.append(np.arange(start + i * w, start + (i + 1) * w))
    return np.concatenate(order)


def permute_fused_tp(leaf: QuantizedTensor, segments: Sequence[int],
                     tp: int) -> QuantizedTensor:
    """Block-permute a fused leaf's out axis for ``tp`` ranks (see
    ``QuantizedTensor.fuse_tp``), on the device where it lies: a move of
    rows and scales, no numeric change. Every segment must divide by tp."""
    if leaf.fuse_tp == tp:
        return leaf
    if leaf.fuse_tp != 1:
        raise ValueError("re-blocking a blocked leaf is not supported")
    if any(s % tp for s in segments):
        raise ValueError(f"segments {tuple(segments)} not divisible by tp={tp}")
    order = torch.from_numpy(_blocked_order(segments, tp)).to(leaf.q.device)
    q = leaf.q.index_select(leaf.q.ndim - (2 if leaf.transposed else 1), order)
    grouped_t = leaf.group_size != leaf.in_features and leaf.transposed
    s_axis = leaf.scales.ndim - (2 if grouped_t else 1)  # [.., out, in/g] or [.., *, out]
    return replace(leaf, q=q, scales=leaf.scales.index_select(s_axis, order), fuse_tp=tp)


def _concat_linears(leaves) -> Any:
    """Concat linear leaves along out-features (dense or quantized).

    Quantized leaves are concatenated in the non-transposed layout (q
    ``[.., in(/2), out]``, scales ``[.., in/g, out]`` or ``[.., 1, out]``),
    then stored by `auto_orient`, as the JAX package does: a fused leaf is
    wider than its parts, so its orientation may differ from theirs. LoRA
    leaves do not fuse (their adaptors would have to be block-diagonal)."""
    if any(isinstance(w, LoraLinear) for w in leaves):
        raise ValueError("cannot fuse LoRA-adapted projections")
    if all(isinstance(w, QuantizedTensor) for w in leaves):
        qs = [with_orientation(w, False) for w in leaves]
        layout = {(w.bits, w.group_size, w.act_bits, w.in_features) for w in qs}
        if len(layout) != 1:
            raise ValueError("quantized projections disagree on layout")
        first = qs[0]
        return auto_orient(QuantizedTensor(
            q=torch.cat([w.q for w in qs], dim=-1),
            scales=torch.cat([w.scales for w in qs], dim=-1),
            bits=first.bits, group_size=first.group_size, act_bits=first.act_bits))
    if any(isinstance(w, QuantizedTensor) for w in leaves):
        raise ValueError("cannot fuse mixed dense/quantized projections")
    return torch.cat(leaves, dim=-1)


def fuse_projections(params: Dict[str, Any], config: ModelConfig) -> Dict[str, Any]:
    """Return a tree with wq/wk/wv fused to ``wqkv`` and w1/w3 to ``w13``,
    and with biases (``use_bias``) their ``_b`` leaves concatenated to
    ``wqkv_b`` / ``w13_b``. MoE expert stacks stay as they are (the decode
    path reads w1 and w3 apart, `models/decode._moe_ffn_decode`), and so do
    an MLP's w1 and w2 (``ffn_type == "mlp"``: there is no w3). A group
    that `_concat_linears` refuses (LoRA, or dense beside quantized) raises
    its ``ValueError``."""
    out = dict(params)
    layers = dict(params["layers"])
    groups = [(("wq", "wk", "wv"), "wqkv")]
    if not config.num_experts and config.ffn_type != "mlp":
        groups.append((("w1", "w3"), "w13"))
    for names, fused in groups:
        if all(n in layers for n in names):
            layers[fused] = _concat_linears([layers[n] for n in names])
            for n in names:
                del layers[n]
            biases = [n + "_b" for n in names]
            if config.use_bias and all(b in layers for b in biases):
                layers[fused + "_b"] = torch.cat([layers.pop(b) for b in biases], dim=-1)
    out["layers"] = layers
    return out
