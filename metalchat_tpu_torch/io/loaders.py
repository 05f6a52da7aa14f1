"""HF Llama / Gemma-3 / Mixtral checkpoint ↔ parameter tree (port of the
JAX package's ``io/loaders.py`` ``load_params`` and ``save_params``, HF
names only).

Linear weights are transposed from the checkpoint's ``[out, in]`` to
``[in, out]`` and stacked over layers, as in the JAX package. Gemma-3's
FFN pre-norm is ``pre_feedforward_layernorm`` (its
``post_attention_layernorm`` is the post-attention norm), beside the
post-FFN norm and the q/k norms; its lm_head is tied to the embedding.
Mixtral's sparse-MoE names, ``block_sparse_moe.gate`` and
``block_sparse_moe.experts.N.w{1,2,3}`` (w1 the gate, w3 the up and w2 the
down projection), stack to the router ``[L, H, E]`` and the experts ``[L, E,
in, out]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from metalchat_tpu_torch.config import Gemma3Config, ModelConfig
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.safetensors import SafetensorsDocument
from metalchat_tpu_torch.models.transformer import Params, make_rope_tables


def load_params(doc: SafetensorsDocument, config: ModelConfig, *,
                dtype=torch.bfloat16, max_seq_len: Optional[int] = None,
                device=None) -> Params:
    """Build the parameter tree from an HF-named safetensors document."""
    dev = resolve_device(device)

    def get(name: str) -> torch.Tensor:
        return doc.torch_tensor(name).to(dtype)

    def linear(name: str) -> torch.Tensor:
        return get(name).T.contiguous()  # [out, in] → [in, out]

    def stack(template: str, fn) -> torch.Tensor:
        return torch.stack([fn(template.format(i=i))
                            for i in range(config.num_layers)]).to(dev)

    pre = "model.layers.{i}."
    layers: Dict[str, torch.Tensor] = {
        "attn_norm": stack(pre + "input_layernorm.weight", get),
        "wq": stack(pre + "self_attn.q_proj.weight", linear),
        "wk": stack(pre + "self_attn.k_proj.weight", linear),
        "wv": stack(pre + "self_attn.v_proj.weight", linear),
        "wo": stack(pre + "self_attn.o_proj.weight", linear),
    }
    if config.num_experts:
        moe = pre + "block_sparse_moe."

        def experts(name: str) -> torch.Tensor:
            return stack(moe + "experts.{{j}}." + name + ".weight", lambda t: torch.stack(
                [linear(t.format(j=j)) for j in range(config.num_experts)]))

        layers["router"] = stack(moe + "gate.weight", linear)
        for name in ("w1", "w3", "w2"):
            layers[name] = experts(name)
    else:
        layers["w1"] = stack(pre + "mlp.gate_proj.weight", linear)
        layers["w3"] = stack(pre + "mlp.up_proj.weight", linear)
        layers["w2"] = stack(pre + "mlp.down_proj.weight", linear)
    if isinstance(config, Gemma3Config) or config.norm_weight_offset != 0.0:
        layers["ffn_norm"] = stack(pre + "pre_feedforward_layernorm.weight", get)
        layers["post_attn_norm"] = stack(pre + "post_attention_layernorm.weight", get)
        layers["post_ffn_norm"] = stack(pre + "post_feedforward_layernorm.weight", get)
        layers["q_norm"] = stack(pre + "self_attn.q_norm.weight", get)
        layers["k_norm"] = stack(pre + "self_attn.k_norm.weight", get)
    else:
        layers["ffn_norm"] = stack(pre + "post_attention_layernorm.weight", get)
    embed = get("model.embed_tokens.weight")
    if "lm_head.weight" in doc:
        lm_head = linear("lm_head.weight")
    elif config.tie_word_embeddings:
        lm_head = embed.T.contiguous()
    else:
        raise KeyError("checkpoint has no lm_head.weight and embeddings are not tied")
    return {
        "embed": embed.to(dev),
        "layers": layers,
        "final_norm": get("model.norm.weight").to(dev),
        "lm_head": lm_head.to(dev),
        "rope": make_rope_tables(config, max_seq_len, device=dev),
    }


def save_params(params: Params, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flatten a dense parameter tree back to HF-named CPU tensors (for
    `io.safetensors.save_safetensors`): linear weights ``[out, in]`` again,
    one tensor a layer, no lm_head when the embeddings are tied."""

    def host(t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, torch.Tensor):
            raise TypeError("save_params takes dense parameters, not quantized leaves")
        return t.detach().contiguous().to("cpu")

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    if not config.tie_word_embeddings:
        out["lm_head.weight"] = host(params["lm_head"].T)
    name_map = {
        "attn_norm": "input_layernorm.weight",
        "wq": "self_attn.q_proj.weight",
        "wk": "self_attn.k_proj.weight",
        "wv": "self_attn.v_proj.weight",
        "wo": "self_attn.o_proj.weight",
        "w1": "mlp.gate_proj.weight",
        "w3": "mlp.up_proj.weight",
        "w2": "mlp.down_proj.weight",
        "q_norm": "self_attn.q_norm.weight",
        "k_norm": "self_attn.k_norm.weight",
        "post_attn_norm": "post_attention_layernorm.weight",
        "post_ffn_norm": "post_feedforward_layernorm.weight",
        "ffn_norm": ("pre_feedforward_layernorm.weight" if config.norm_weight_offset != 0.0
                     else "post_attention_layernorm.weight"),
    }
    moe = bool(config.num_experts)
    for key, stacked in params["layers"].items():
        for i in range(config.num_layers):
            w = stacked[i]
            if moe and key == "router":
                out[f"model.layers.{i}.block_sparse_moe.gate.weight"] = host(w.T)
            elif moe and key in ("w1", "w2", "w3"):
                for j in range(config.num_experts):
                    out[f"model.layers.{i}.block_sparse_moe.experts.{j}.{key}.weight"] = (
                        host(w[j].T))
            elif key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
                out[f"model.layers.{i}.{name_map[key]}"] = host(w.T)
            else:
                out[f"model.layers.{i}.{name_map[key]}"] = host(w)
    return out
