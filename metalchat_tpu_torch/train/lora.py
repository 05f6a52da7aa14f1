"""LoRA adaptor attachment and merging on parameter trees (port of the JAX
package's ``train/lora.py``).

Target leaves (dense ``[L, in, out]`` tensors or `QuantizedTensor`s) are
wrapped in `LoraLinear`, whose forward `quant.quantize.linear` already
runs. B starts at zero, so the adapted model is exactly the base model at
step 0.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor, dequantize

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _leaf_dims(leaf) -> Tuple[int, int, Tuple[int, ...], torch.device]:
    """(in_features, out_features, stack_dims, device) of a linear leaf."""
    if isinstance(leaf, QuantizedTensor):
        return leaf.in_features, leaf.out_features, tuple(leaf.q.shape[:-2]), leaf.q.device
    return leaf.shape[-2], leaf.shape[-1], tuple(leaf.shape[:-2]), leaf.device


def attach_lora(params: Dict[str, Any], *, rank: int = 8, scale: float = 2.0,
                targets: Iterable[str] = DEFAULT_TARGETS, seed: int = 0,
                dtype=torch.float32,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Wrap target linear leaves in LoraLinear(base, A, B).

    A ~ N(0, 1/rank), drawn target by target from ``generator`` (by default
    a ``torch.Generator`` on the leaves' device seeded with ``seed``), B = 0:
    the reference's adaptor shapes (A ``[in, r]``, B ``[r, out]``) with the
    stacked layer axis; ``scale`` defaults to the reference's 2.0."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    gen = generator
    for name in targets:
        leaf = out["layers"].get(name)
        if leaf is None or isinstance(leaf, LoraLinear):
            continue
        in_f, out_f, stack, dev = _leaf_dims(leaf)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        a = (torch.randn((*stack, in_f, rank), generator=gen, device=dev)
             * rank ** -0.5).to(dtype)
        b = torch.zeros((*stack, rank, out_f), dtype=dtype, device=dev)
        out["layers"][name] = LoraLinear(base=leaf, a=a, b=b, scale=scale)
    return out


def _fold(leaf, dtype):
    base = leaf.base
    if isinstance(base, QuantizedTensor):
        base = dequantize(base, torch.float32)
    delta = torch.einsum("...ir,...ro->...io", leaf.a.float(), leaf.b.float()) * leaf.scale
    return (base.float() + delta).to(dtype)


def merge_lora(params: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    """Fold adaptors into dense weights: W' = dequant(base) + scale · A @ B,
    in f32, then ``dtype``. A plain dense tree (no adaptor products when
    served)."""
    def walk(node):
        if isinstance(node, LoraLinear):
            return _fold(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def lora_param_count(params: Dict[str, Any]) -> int:
    """Number of trainable adaptor parameters."""
    def walk(node) -> int:
        if isinstance(node, LoraLinear):
            return node.a.numel() + node.b.numel()
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return 0

    return walk(params)
