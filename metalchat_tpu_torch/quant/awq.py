"""AWQ-style activation-aware scale folding (port of the JAX package's
``quant/awq.py``).

Per-channel int4 (the W4A8 scheme) loses accuracy against group-32 because
a few salient input channels set every output channel's quantization step.
AWQ (Lin et al., 2023, arXiv:2306.00978) scales the weight rows of salient
channels up and the incoming activation down before quantization: exact in
f32, but it moves quantization error away from the channels that matter.

The four folds are exact; the inverse scale goes into an adjacent parameter:

* wq/wk/wv rows ⇐ the attention norm weight (h → h/s, W → s·W);
* w1/w3 rows ⇐ the FFN norm weight;
* wo rows ⇐ wv's output columns (attention is linear in V; under GQA the
  statistic is averaged over each query-head group);
* w2 rows ⇐ w3's output columns (swiglu is linear in the w3 branch).

`calibration_stats` walks the dense model in f32 on the parameters' device
and taps the activations entering each foldable projection through a
callable (`quant/gptq.hessian_tap` collects Hessians through the same
walk); on the card the statistics stay on the device. The saliency scales
are computed in f64 and cast to f32, and every fold is an f32 product or
quotient cast to the parameters' dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import embed_tokens, layer_rope, norm, rms_norm
from metalchat_tpu_torch.ops import reference as ops


def mean_abs_tap(h: torch.Tensor) -> torch.Tensor:
    """AWQ's saliency statistic: mean |h| over batch and sequence, f32."""
    return h.float().abs().mean(dim=(0, 1))


def _act(config: ModelConfig):
    return ops.gelu_tanh if config.hidden_act == "gelu_tanh" else torch.nn.functional.silu


@torch.no_grad()
def calibration_stats(params: Dict[str, Any], config: ModelConfig, tokens,
                      tap: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Statistics of the activations entering each foldable projection.

    Walks the dense (unquantized) model layer by layer in f32 with the JAX
    package's ops: the embedding cast to f32, the pre-norm, q/k/v (the
    weights upcast to f32), the optional q/k norms, rope (or none), the
    causal mask and sliding window, attention, wo, the post norms, then the
    MLP or SwiGLU. Projection biases are not added, as in JAX. Returns
    ``{"qkv", "wo", "w13", "w2"}``, each the layers' ``tap(h)`` stacked on a
    leading layer axis. ``tap`` defaults to `mean_abs_tap`."""
    if config.num_experts:
        raise NotImplementedError("AWQ calibration: dense FFN models only")
    tap = tap or mean_abs_tap
    dev = params["final_norm"].device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    b, s = tokens.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    valid = torch.full((b, 1, 1), s, dtype=torch.int32, device=dev)
    scale = config.query_scale if config.query_scale is not None else hd ** -0.5
    act = _act(config)
    layers = params["layers"]

    def proj(h, name, l):
        return h @ layers[name][l].float()

    x = embed_tokens(params, tokens, positions, config).float()
    stats: Dict[str, list] = {"qkv": [], "wo": [], "w13": [], "w2": []}
    for l in range(config.num_layers):
        is_global = config.layer_is_global(l)
        h = norm(x, layers, "attn_norm", config, l)
        stats["qkv"].append(tap(h))
        q = proj(h, "wq", l).reshape(b, s, nh, hd)
        k = proj(h, "wk", l).reshape(b, s, nkv, hd)
        v = proj(h, "wv", l).reshape(b, s, nkv, hd)
        if config.use_qk_norm:
            q = rms_norm(q, layers["q_norm"][l], config)
            k = rms_norm(k, layers["k_norm"][l], config)
        if config.position_embedding == "rope":
            cos, sin = layer_rope(params["rope"], config, l)
            q = ops.apply_rope(q, cos, sin, positions)
            k = ops.apply_rope(k, cos, sin, positions)
        window = None if config.sliding_window is None or is_global else config.sliding_window
        mask = ops.causal_mask(positions, s, valid, window)
        attn = ops.attention(q, k.transpose(1, 2), v.transpose(1, 2), mask, scale=scale)
        attn = attn.reshape(b, s, nh * hd)
        stats["wo"].append(tap(attn))
        attn = proj(attn, "wo", l)
        if config.use_post_norms:
            attn = rms_norm(attn, layers["post_attn_norm"][l], config)
        x = x + attn

        h = norm(x, layers, "ffn_norm", config, l)
        stats["w13"].append(tap(h))
        gate = act(proj(h, "w1", l))
        if config.ffn_type != "mlp":
            gate = gate * proj(h, "w3", l)
        stats["w2"].append(tap(gate))
        ffn = proj(gate, "w2", l)
        if config.use_post_norms:
            ffn = rms_norm(ffn, layers["post_ffn_norm"][l], config)
        x = x + ffn
    return {name: torch.stack(v) for name, v in stats.items()}


def _saliency_scale(stat: torch.Tensor, alpha: float) -> torch.Tensor:
    """s = |x|^α in f64, normalized to geometric mean 1 over the last axis,
    clipped to [1e-4, 1e4], cast to f32."""
    s = stat.double().clamp_min(1e-8) ** alpha
    s = s / torch.exp(torch.log(s).mean(dim=-1, keepdim=True))
    return s.clamp(1e-4, 1e4).float()


def _group_mean(s: torch.Tensor) -> torch.Tensor:
    """Mean over axis 2 of ``[L, nkv, groups, hd]`` in f32, summed in
    order (numpy's reduction over a non-last axis), then divided."""
    total = s[:, :, 0]
    for g in range(1, s.shape[2]):
        total = total + s[:, :, g]
    return total / s.shape[2]


@torch.no_grad()
def awq_fold(params: Dict[str, Any], config: ModelConfig, stats: Dict[str, torch.Tensor],
             alpha: float = 0.5) -> Dict[str, Any]:
    """A new parameter tree with the saliency scales folded in (exact before
    quantization). Quantize the result per channel (``group_size=None``):
    the folds target per-channel schemes. Without w3 (the GPT-2 MLP) the w2
    fold is skipped: gelu is not channel-scale-equivariant."""
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim
    groups = nh // nkv
    layers = params["layers"]
    dtype = layers["attn_norm"].dtype
    dev = layers["attn_norm"].device

    def scale(name):
        return _saliency_scale(stats[name].to(dev), alpha)

    s_qkv, s_w13, s_w2 = scale("qkv"), scale("w13"), scale("w2")   # [L, h], [L, h], [L, f]
    s_wo_full = scale("wo")                                          # [L, nh*hd]
    L = s_wo_full.shape[0]
    # GQA: one scale per (kv head, dim), shared by its query-head group.
    s_v = _group_mean(s_wo_full.reshape(L, nkv, groups, hd))         # [L, nkv, hd]
    s_wo = s_v.repeat_interleave(groups, dim=1).reshape(L, nh * hd)

    def rows(name, s):      # W → s·W on the in axis
        return (layers[name].float() * s[:, :, None]).to(dtype)

    out_layers = dict(layers)
    out_layers["attn_norm"] = (layers["attn_norm"].float() / s_qkv).to(dtype)
    if "attn_norm_b" in layers:
        out_layers["attn_norm_b"] = (layers["attn_norm_b"].float() / s_qkv).to(dtype)
    for name in ("wq", "wk", "wv"):
        out_layers[name] = rows(name, s_qkv)
    # wv's output columns absorb 1/s_v; wo's rows absorb s.
    out_layers["wv"] = (out_layers["wv"].float() / s_v.reshape(L, 1, nkv * hd)).to(dtype)
    out_layers["wo"] = rows("wo", s_wo)

    out_layers["ffn_norm"] = (layers["ffn_norm"].float() / s_w13).to(dtype)
    if "ffn_norm_b" in layers:
        out_layers["ffn_norm_b"] = (layers["ffn_norm_b"].float() / s_w13).to(dtype)
    out_layers["w1"] = rows("w1", s_w13)
    if "w3" in layers:
        w3 = layers["w3"].float() * s_w13[:, :, None]
        out_layers["w3"] = (w3 / s_w2[:, None, :]).to(dtype)
        out_layers["w2"] = rows("w2", s_w2)

    out = dict(params)
    out["layers"] = out_layers
    return out


def awq_quantize_params(params: Dict[str, Any], config: ModelConfig, calibration_tokens, *,
                        bits: int = 4, act_bits: Optional[int] = 8, alpha: float = 0.5,
                        clip_search: bool = True, **quant_kw) -> Dict[str, Any]:
    """Calibrate → fold → per-channel `quantize_params`, in one call."""
    from metalchat_tpu_torch.quant.quantize import quantize_params

    stats = calibration_stats(params, config, calibration_tokens)
    folded = awq_fold(params, config, stats, alpha=alpha)
    return quantize_params(folded, bits=bits, group_size=None, act_bits=act_bits,
                           clip_search=clip_search, **quant_kw)
