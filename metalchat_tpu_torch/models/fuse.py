"""Projection fusion: wq/wk/wv → ``wqkv`` and w1/w3 → ``w13`` (port of the
JAX package's ``models/fuse.py``, plain concatenation only: ``fuse_tp=1``).

Concatenating along out-features is exact: for quantized leaves the packed
bytes and scales concatenate unchanged (groups run along in-features). Fewer,
wider matvecs mean fewer kernel launches per layer.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

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


def split_fused(y: torch.Tensor, segments: Sequence[int]):
    """Split a fused projection output back into its segments (views)."""
    return torch.split(y, list(segments), dim=-1)


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
