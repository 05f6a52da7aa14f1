"""Quantized-checkpoint serialization (port of the JAX package's
``quant/checkpoint.py``).

Two dialects on disk:

* **native**: HF-style tensor names with ``.qweight`` / ``.scales`` /
  ``.lora_a`` / ``.lora_b`` leaves and ``__metadata__`` carrying ``bits``,
  ``group_size`` (``"channel"`` for per-channel scales), ``act_bits``,
  ``int4_packing`` and ``lora_scale``. Quantized leaves are written in the
  canonical orientation (q ``[in(/2), out]``, scales ``[in/g, out]``) and
  stored again by `auto_orient` on load; packed int4 stays packed.
* **reference QLoRA**: the reference's internal names
  (``layers.N.attention.wq.weight`` int8 ``[out, in]``, ``.scales`` f32
  ``[out, in/group]``, ``.adaptor.A.weight`` ``[rank, in]``,
  ``.adaptor.B.weight`` ``[out, rank]``; ``tok_embeddings`` int8 + scales;
  ``output`` int8 + scales or absent (tied); norms), LoRA scale 2.0, group
  32, transposed here into the ``[in, out]`` convention.

Files go through ``io/safetensors.save_safetensors`` and
``open_safetensors``. The loaders take ``device=`` and ``dtype=`` as
``io/loaders.py`` does: tensors are read on the host, moved to the device,
stacked and transposed there.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.safetensors import SafetensorsDocument
from metalchat_tpu_torch.models.transformer import Params, make_rope_tables
from metalchat_tpu_torch.quant.quantize import (
    LoraLinear,
    QuantizedTensor,
    auto_orient,
    with_orientation,
)

_HF_NAMES = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w1": "mlp.gate_proj",
    "w3": "mlp.up_proj",
    "w2": "mlp.down_proj",
}
_NORM_NAMES = {
    "attn_norm": "input_layernorm.weight",
    "ffn_norm": "post_attention_layernorm.weight",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
    "post_attn_norm": "post_attention_layernorm.weight",
    "post_ffn_norm": "post_feedforward_layernorm.weight",
}
INT4_PACKING = "halfsplit-offsetlo"


def _canonical(leaf):
    """A quantized leaf (or a LoRA leaf's quantized base) in the on-disk
    orientation; anything else as it is."""
    if isinstance(leaf, QuantizedTensor):
        return with_orientation(leaf, False)
    if isinstance(leaf, LoraLinear):
        return replace(leaf, base=_canonical(leaf.base))
    return leaf


def export_quantized(params: Params, config: ModelConfig
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Flatten a (quantized, LoRA or dense) parameter tree to native-format
    tensors and metadata, in the JAX package's order and layouts: pass both
    to `save_safetensors`. Each metadata key takes its value from the first
    leaf that sets it."""
    tensors: Dict[str, torch.Tensor] = {}
    meta: Dict[str, str] = {}

    def put_leaf(prefix: str, leaf, i: Optional[int] = None):
        """``leaf`` (layer ``i`` of it, if given) under ``prefix``."""
        def sel(t: torch.Tensor) -> torch.Tensor:
            return t if i is None else t[i]

        if isinstance(leaf, LoraLinear):
            put_leaf(prefix, leaf.base, i)
            tensors[prefix + ".lora_a"] = sel(leaf.a)
            tensors[prefix + ".lora_b"] = sel(leaf.b)
            meta.setdefault("lora_scale", str(leaf.scale))
        elif isinstance(leaf, QuantizedTensor):
            per_channel = leaf.group_size == leaf.in_features
            leaf = with_orientation(leaf, False)  # the canonical on-disk layout
            tensors[prefix + ".qweight"] = sel(leaf.q)
            tensors[prefix + ".scales"] = sel(leaf.scales)
            meta.setdefault("bits", str(leaf.bits))
            meta.setdefault("group_size", "channel" if per_channel else str(leaf.group_size))
            if leaf.bits == 4:
                meta.setdefault("int4_packing", INT4_PACKING)
            if leaf.act_bits:
                meta.setdefault("act_bits", str(leaf.act_bits))
        else:
            tensors[prefix + ".weight"] = sel(leaf).transpose(-1, -2).contiguous()

    embed = params["embed"]
    if isinstance(embed, QuantizedTensor):
        tensors["model.embed_tokens.qweight"] = embed.q
        tensors["model.embed_tokens.scales"] = embed.scales
        meta.setdefault("bits", str(embed.bits))
        meta.setdefault("group_size", str(embed.group_size))
    else:
        tensors["model.embed_tokens.weight"] = embed
    tensors["model.norm.weight"] = params["final_norm"]
    put_leaf("lm_head", params["lm_head"])

    for key, stacked in params["layers"].items():
        stacked = _canonical(stacked)  # orient a stacked leaf once, not once a layer
        for i in range(config.num_layers):
            base = f"model.layers.{i}."
            if key in _HF_NAMES:
                put_leaf(base + _HF_NAMES[key], stacked, i)
            else:
                name = _NORM_NAMES[key]
                if key == "ffn_norm" and config.use_post_norms:
                    name = "pre_feedforward_layernorm.weight"
                tensors[base + name] = stacked[i]
    return tensors, meta


def load_quantized(doc: SafetensorsDocument, config: ModelConfig, *, dtype=torch.bfloat16,
                   max_seq_len: Optional[int] = None, device=None) -> Params:
    """A native-format quantized checkpoint back into a parameter tree:
    quantized leaves stored by `auto_orient` with their group size derived
    from the shapes, LoRA adaptors as stored, dense leaves and norms in
    ``dtype``. Another int4 packing than this build's raises."""
    dev = resolve_device(device)
    bits = int(doc.metadata.get("bits", 8))
    if bits == 4:
        packing = doc.metadata.get("int4_packing", INT4_PACKING)
        if packing != INT4_PACKING:
            raise ValueError(
                f"unsupported int4 packing {packing!r}: this build stores the "
                "low nibble offset-binary (lo+8); re-export the checkpoint")
    act_bits_meta = doc.metadata.get("act_bits")
    act_bits = int(act_bits_meta) if act_bits_meta else None
    lora_scale = float(doc.metadata.get("lora_scale", 2.0))
    L = config.num_layers

    def read(name: str) -> torch.Tensor:
        return doc.torch_tensor(name).to(dev)

    def get(prefix: str, stack: bool, suffix: str,
            transform: Callable[[torch.Tensor], torch.Tensor] = lambda t: t) -> torch.Tensor:
        if stack:
            return torch.stack([transform(read(f"model.layers.{i}.{prefix}{suffix}"))
                                for i in range(L)])
        return transform(read(prefix + suffix))

    def leaf(prefix: str, stack: bool):
        probe = f"model.layers.0.{prefix}" if stack else prefix
        if probe + ".qweight" in doc:
            q, scales = get(prefix, stack, ".qweight"), get(prefix, stack, ".scales")
            # Canonical orientation on disk: q [in(/2), out], scales [in/g, out].
            in_features = q.shape[-2] * (2 if bits == 4 else 1)
            qt = auto_orient(QuantizedTensor(
                q=q, scales=scales, bits=bits, group_size=in_features // scales.shape[-2],
                act_bits=act_bits))
            if probe + ".lora_a" in doc:
                return LoraLinear(base=qt, a=get(prefix, stack, ".lora_a"),
                                  b=get(prefix, stack, ".lora_b"), scale=lora_scale)
            return qt
        return get(prefix, stack, ".weight", lambda t: t.T.contiguous()).to(dtype)

    def norm(name: str, stack: bool = True) -> torch.Tensor:
        return get(name, stack, "").to(dtype)

    layers: Dict[str, Any] = {key: leaf(hf, stack=True) for key, hf in _HF_NAMES.items()}
    layers["attn_norm"] = norm("input_layernorm.weight")
    if config.use_post_norms:
        layers["ffn_norm"] = norm("pre_feedforward_layernorm.weight")
        layers["post_attn_norm"] = norm("post_attention_layernorm.weight")
        layers["post_ffn_norm"] = norm("post_feedforward_layernorm.weight")
    else:
        layers["ffn_norm"] = norm("post_attention_layernorm.weight")
    if config.use_qk_norm:
        layers["q_norm"] = norm("self_attn.q_norm.weight")
        layers["k_norm"] = norm("self_attn.k_norm.weight")

    if "model.embed_tokens.qweight" in doc:
        eq, es = read("model.embed_tokens.qweight"), read("model.embed_tokens.scales")
        # A row-quantized table: groups run along H (the last axis of a row).
        group = eq.shape[-1] * (2 if bits == 4 else 1) // es.shape[-1]
        embed: Any = QuantizedTensor(q=eq, scales=es, bits=bits, group_size=group)
    else:
        embed = read("model.embed_tokens.weight").to(dtype)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": norm("model.norm.weight", stack=False),
        "lm_head": leaf("lm_head", stack=False),
        "rope": make_rope_tables(config, max_seq_len, device=dev),
    }


# -- the reference's QLoRA dialect ---------------------------------------------

_REF_LINEARS = {
    "wq": "attention.wq",
    "wk": "attention.wk",
    "wv": "attention.wv",
    "wo": "attention.wo",
    "w1": "feed_forward.w1",
    "w2": "feed_forward.w2",
    "w3": "feed_forward.w3",
}


def load_reference_qlora(doc: SafetensorsDocument, config: ModelConfig, *, bits: int = 8,
                         group_size: int = 32, lora_scale: float = 2.0,
                         dtype=torch.bfloat16, max_seq_len: Optional[int] = None,
                         device=None) -> Params:
    """A QLoRA checkpoint in the reference's internal naming (scale 2.0 and
    group 32 by default, as the reference's Llama loader sets them).

    Reference orientation: weight int8 ``[out, in]``, scales ``[out,
    in/group]`` (read as f32), ``adaptor.A.weight [rank, in]``,
    ``adaptor.B.weight [out, rank]`` (cast to ``dtype``), all transposed
    into ``[in, out]``; the linears stored by `auto_orient`. A missing
    ``output.weight`` ties the head to the quantized embedding, swapped to
    ``[H, V]`` in the natural layout (as the JAX package does)."""
    dev = resolve_device(device)
    L = config.num_layers

    def read(name: str) -> torch.Tensor:
        return doc.torch_tensor(name).to(dev)

    def t(x: torch.Tensor) -> torch.Tensor:  # [out, in] → [in, out]
        return x.transpose(-1, -2).contiguous()

    def stack(template: str) -> torch.Tensor:
        return torch.stack([read(template.format(i=i)) for i in range(L)])

    def lora_stack(ref_name: str) -> LoraLinear:
        p = "layers.{i}." + ref_name
        # The file's [out, in] is the transposed storage; auto_orient keeps
        # it for wide outputs and swaps the rest to [in, out].
        qt = auto_orient(QuantizedTensor(
            q=stack(p + ".weight"), scales=stack(p + ".scales").float(), bits=bits,
            group_size=group_size, transposed=True))
        return LoraLinear(base=qt, a=t(stack(p + ".adaptor.A.weight")).to(dtype),
                          b=t(stack(p + ".adaptor.B.weight")).to(dtype), scale=lora_scale)

    layers: Dict[str, Any] = {k: lora_stack(v) for k, v in _REF_LINEARS.items()}
    layers["attn_norm"] = stack("layers.{i}.attention_norm.weight").to(dtype)
    layers["ffn_norm"] = stack("layers.{i}.ffn_norm.weight").to(dtype)

    embed = QuantizedTensor(q=read("tok_embeddings.weight"),
                            scales=read("tok_embeddings.scales").float(), bits=bits,
                            group_size=group_size)
    lm_head: Any
    if "output.weight" in doc:
        if "output.scales" in doc:
            lm_head = QuantizedTensor(q=t(read("output.weight")),
                                      scales=t(read("output.scales").float()), bits=bits,
                                      group_size=group_size)
        else:
            lm_head = t(read("output.weight")).to(dtype)
    else:
        lm_head = QuantizedTensor(q=t(embed.q), scales=t(embed.scales), bits=bits,
                                  group_size=group_size)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": read("norm.weight").to(dtype),
        "lm_head": lm_head,
        "rope": make_rope_tables(config, max_seq_len, device=dev),
    }
