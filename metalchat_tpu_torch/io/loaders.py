"""HF Llama / Gemma-3 / Mixtral / GPT-2 and Meta Llama checkpoints ↔
parameter tree (port of the JAX package's ``io/loaders.py``
``load_params``, ``load_gpt2_params`` and ``save_params``).

Linear weights are transposed from the checkpoint's ``[out, in]`` to
``[in, out]`` and stacked over layers, as in the JAX package. Gemma-3's
FFN pre-norm is ``pre_feedforward_layernorm`` (its
``post_attention_layernorm`` is the post-attention norm), beside the
post-FFN norm and the q/k norms; its lm_head is tied to the embedding.
Mixtral's sparse-MoE names, ``block_sparse_moe.gate`` and
``block_sparse_moe.experts.N.w{1,2,3}`` (w1 the gate, w3 the up and w2 the
down projection), stack to the router ``[L, H, E]`` and the experts ``[L, E,
in, out]``.

A Meta-format checkpoint (``source="meta"``) is renamed to HF names in
place, its lm_head aliased to the embedding when missing, and its q/k rows
permuted from Meta's interleaved rope layout to HF's half-split one.

A GPT-2 checkpoint (``load_gpt2_params``) has its own names (``wte``,
``wpe``, ``h.N.*``, ``ln_f``); its Conv1D weights are already ``[in, out]``,
and the fused ``c_attn`` splits into wq/wk/wv with their biases.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from metalchat_tpu_torch.config import Gemma3Config, ModelConfig
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.safetensors import SafetensorsDocument
from metalchat_tpu_torch.models.transformer import Params, make_rope_tables

# Meta checkpoint names → HF names.
_META_RENAMES = [
    (r"^tok_embeddings\.weight$", "model.embed_tokens.weight"),
    (r"^norm\.weight$", "model.norm.weight"),
    (r"^output\.weight$", "lm_head.weight"),
    (r"^layers\.(\d+)\.attention\.wq\.weight$", r"model.layers.\1.self_attn.q_proj.weight"),
    (r"^layers\.(\d+)\.attention\.wk\.weight$", r"model.layers.\1.self_attn.k_proj.weight"),
    (r"^layers\.(\d+)\.attention\.wv\.weight$", r"model.layers.\1.self_attn.v_proj.weight"),
    (r"^layers\.(\d+)\.attention\.wo\.weight$", r"model.layers.\1.self_attn.o_proj.weight"),
    (r"^layers\.(\d+)\.feed_forward\.w1\.weight$", r"model.layers.\1.mlp.gate_proj.weight"),
    (r"^layers\.(\d+)\.feed_forward\.w2\.weight$", r"model.layers.\1.mlp.down_proj.weight"),
    (r"^layers\.(\d+)\.feed_forward\.w3\.weight$", r"model.layers.\1.mlp.up_proj.weight"),
    (r"^layers\.(\d+)\.attention_norm\.weight$", r"model.layers.\1.input_layernorm.weight"),
    (r"^layers\.(\d+)\.ffn_norm\.weight$",
     r"model.layers.\1.post_attention_layernorm.weight"),
]


def permute_qk_meta_to_hf(w: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Meta's interleaved rope layout → HF's half-split one, rows only:
    ``w [num_heads·head_dim, hidden]`` as stored (out-major)."""
    out_dim, in_dim = w.shape
    head_dim = out_dim // num_heads
    return (w.reshape(num_heads, head_dim // 2, 2, in_dim)
            .permute(0, 2, 1, 3).reshape(out_dim, in_dim))


def normalize_meta_document(doc: SafetensorsDocument) -> SafetensorsDocument:
    """Rename a Meta-format checkpoint to HF names, in place."""
    for pattern, repl in _META_RENAMES:
        doc.rename(pattern, repl)
    return doc


def load_params(doc: SafetensorsDocument, config: ModelConfig, *,
                dtype=torch.bfloat16, source: str = "hf",
                max_seq_len: Optional[int] = None, device=None) -> Params:
    """Build the parameter tree from a safetensors document: HF-named, or
    with ``source="meta"`` a Meta-format one (renamed in place, the tied
    lm_head aliased, q/k permuted to HF's rope layout)."""
    dev = resolve_device(device)
    if source == "meta":
        normalize_meta_document(doc)
        doc.alias_if_missing("lm_head.weight", "model.embed_tokens.weight")

    def get(name: str) -> torch.Tensor:
        return doc.torch_tensor(name).to(dtype)

    def linear(name: str) -> torch.Tensor:
        return get(name).T.contiguous()  # [out, in] → [in, out]

    def qk(heads: int):
        def load(name: str) -> torch.Tensor:
            if source != "meta":
                return linear(name)
            return permute_qk_meta_to_hf(get(name), heads).T.contiguous()
        return load

    def stack(template: str, fn) -> torch.Tensor:
        return torch.stack([fn(template.format(i=i))
                            for i in range(config.num_layers)]).to(dev)

    pre = "model.layers.{i}."
    layers: Dict[str, torch.Tensor] = {
        "attn_norm": stack(pre + "input_layernorm.weight", get),
        "wq": stack(pre + "self_attn.q_proj.weight", qk(config.num_heads)),
        "wk": stack(pre + "self_attn.k_proj.weight", qk(config.num_kv_heads)),
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


def load_gpt2_params(doc: SafetensorsDocument, config: ModelConfig, *,
                     dtype=torch.bfloat16, max_seq_len: Optional[int] = None,
                     device=None) -> Params:
    """Build the GPT-2 parameter tree from an HF GPT-2 safetensors document
    (names without the ``transformer.`` prefix): layernorms with their
    biases, ``c_attn [H, 3H]`` split into wq/wk/wv (and its bias), the
    learned positions ``pos_emb`` and the lm_head a contiguous copy of
    ``wte``'s transpose (GPT-2 ties them)."""
    dev = resolve_device(device)
    h = config.hidden_size

    def get(name: str) -> torch.Tensor:
        return doc.torch_tensor(name).to(dtype)

    def stack(template: str, part=slice(None)) -> torch.Tensor:
        return torch.stack([get(template.format(i=i))[..., part].contiguous()
                            for i in range(config.num_layers)]).to(dev)

    q, k, v = slice(0, h), slice(h, 2 * h), slice(2 * h, None)
    pre = "h.{i}."
    layers = {
        "attn_norm": stack(pre + "ln_1.weight"), "attn_norm_b": stack(pre + "ln_1.bias"),
        "ffn_norm": stack(pre + "ln_2.weight"), "ffn_norm_b": stack(pre + "ln_2.bias"),
        "wq": stack(pre + "attn.c_attn.weight", q), "wk": stack(pre + "attn.c_attn.weight", k),
        "wv": stack(pre + "attn.c_attn.weight", v),
        "wq_b": stack(pre + "attn.c_attn.bias", q), "wk_b": stack(pre + "attn.c_attn.bias", k),
        "wv_b": stack(pre + "attn.c_attn.bias", v),
        "wo": stack(pre + "attn.c_proj.weight"), "wo_b": stack(pre + "attn.c_proj.bias"),
        "w1": stack(pre + "mlp.c_fc.weight"), "w1_b": stack(pre + "mlp.c_fc.bias"),
        "w2": stack(pre + "mlp.c_proj.weight"), "w2_b": stack(pre + "mlp.c_proj.bias"),
    }
    embed = get("wte.weight")
    return {
        "embed": embed.to(dev),
        "pos_emb": get("wpe.weight").to(dev),
        "layers": layers,
        "final_norm": get("ln_f.weight").to(dev),
        "final_norm_b": get("ln_f.bias").to(dev),
        "lm_head": embed.T.contiguous().to(dev),
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
