"""Mixture-of-experts FFN, Mixtral-style top-k routing (port of the JAX
package's ``models/moe.py``).

Two schemes, chosen by the token count:

* ``_moe_dense`` (at most ``DENSE_TOKEN_CUTOFF`` tokens): every expert
  computes every token and the renormalised top-k gates select; exact.
* ``_moe_dispatch`` (more tokens, the prefill): dispatch and combine
  einsums over a static expert capacity, ``min(t, max(1, ceil(t·k·factor
  / e)))`` slots an expert. Slots go to all first choices before any second
  choice (a k-major cumulative sum); a (token, choice) past its expert's
  capacity is dropped and contributes a zero row.

Decode windows do not come here: ``models/decode.py`` routes each row to
its experts through the stacked matvec kernel (``_moe_ffn_decode``).

Layout per layer (stacked leaves in the parameter tree carry a leading
layer axis): router ``[H, E]``; w1/w3 ``[E, H, F]`` and w2 ``[E, F, H]``
dense, or ``QuantizedTensor`` over the expert axis (act8: ``q [E, out,
in/2]``, scales ``[E, 1, out]``). Both schemes return the router's
Switch-transformer load-balancing loss beside the output; training adds it
to the objective (``forward(with_aux=True)``, `load_balancing_loss`).
``kernels=False`` keeps quantized experts off the dequant-matmul kernel
(the differentiable route).

On a mesh (``mesh``, a `parallel.mesh.Mesh`; the JAX package's GSPMD
route on sharded experts): the rank holds E/ep experts, those of global
index ``ep place · E/ep + local index``, each at FFN width F/tp. Every rank
routes alike on the whole router, over all E experts, and runs its own:
w1/w3 column-parallel, w2 row-parallel over tp as `linear_row_parallel`
runs it (act8 codes from the whole row, exact int32 sums; dense f32
partial products), and the gated sum of its experts stays f32 until it is
summed over ep, then takes the single device's one rounding to the
activation dtype. The f32 sum's order is not the single device's: f32
agrees to rounding, and in bf16 a value may land one step off, after which
a token whose router gap is near a tie may take other experts in a later
layer, as two devices of the JAX package may.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.ops import reference as ops
from metalchat_tpu_torch.quant.quantize import QuantizedTensor, linear, linear_row_parallel

# Up to this many tokens the dense (exact) scheme runs: the expert weights
# are read whole either way, so dropping tokens saves nothing.
DENSE_TOKEN_CUTOFF = 32


def _expert_linear(xin: torch.Tensor, leaf, kernels: bool = True) -> torch.Tensor:
    """xin ``[E, C, in]`` through one layer's expert stack: dense ``[E, in,
    out]``, or quantized, one `linear` per expert."""
    if isinstance(leaf, QuantizedTensor):
        return torch.stack([linear(xin[e], leaf.layer(e), kernels=kernels)
                            for e in range(xin.shape[0])])
    return torch.einsum("ech,ehf->ecf", xin, leaf.to(xin.dtype))


def _expert_mlp(xin: torch.Tensor, layer: Dict[str, Any], config: ModelConfig,
                kernels: bool = True, mesh=None) -> torch.Tensor:
    """SwiGLU over every expert at once: xin ``[E, C, H]`` → ``[E, C, H]``;
    on a mesh of tp > 1, w2 row-parallel."""
    act = ops.activation(config.hidden_act)(_expert_linear(xin, layer["w1"], kernels))
    if "w3" in layer:
        act = act * _expert_linear(xin, layer["w3"], kernels)
    if mesh is not None and mesh.tp > 1:
        return linear_row_parallel(act, layer["w2"], mesh)
    return _expert_linear(act, layer["w2"], kernels)


def _rank_experts(layer: Dict[str, Any], mesh) -> slice:
    """The global indices of the experts this rank holds (all without a
    mesh)."""
    w1 = layer["w1"]
    n = (w1.q if isinstance(w1, QuantizedTensor) else w1).shape[0]
    lo = 0 if mesh is None else mesh.index("ep") * n
    return slice(lo, lo + n)


def route(xt: torch.Tensor, router: torch.Tensor, config: ModelConfig):
    """Router: f32 softmax over the experts, top-k, the k gates renormalised.
    Returns (probs ``[T, E]``, gates ``[T, K]``, expert ids ``[T, K]``)."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate_vals, idx = torch.topk(probs, config.num_experts_per_tok, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), idx


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-transformer load-balancing loss: E · Σ_e fraction_e · prob_e."""
    counts = F.one_hot(idx, e).float().sum(dim=(0, 1))
    fraction = counts / counts.sum().clamp_min(1.0)
    return e * (fraction * probs.mean(dim=0)).sum()


def _gated_sum(spec: str, gates: torch.Tensor, outs: torch.Tensor, mesh) -> torch.Tensor:
    """The gate-weighted sum of the experts' outputs, in their dtype (one
    rounding of an f32-accumulated product). Over ep the rank's partial sum
    stays f32 and is summed over ep before that one rounding, so the result
    differs from the single device's only by the f32 sum's order."""
    if mesh is None or mesh.ep == 1:
        return torch.einsum(spec, gates, outs)
    part = torch.einsum(spec, gates.float(), outs.float())
    return mesh.all_reduce(part, axis="ep").to(outs.dtype)


def _moe_dense(xt: torch.Tensor, layer: Dict[str, Any], config: ModelConfig,
               kernels: bool = True, mesh=None):
    e = config.num_experts
    mine = _rank_experts(layer, mesh)
    probs, gate_vals, idx = route(xt, layer["router"], config)
    gates = torch.zeros_like(probs).scatter(1, idx, gate_vals)[:, mine]  # [T, E_local]
    outs = _expert_mlp(xt[None].expand(gates.shape[1], *xt.shape), layer, config, kernels,
                       mesh)  # [E_local, T, H]
    return _gated_sum("te,eth->th", gates.to(xt.dtype), outs, mesh), _aux_loss(probs, idx, e)


def capacity(t: int, config: ModelConfig) -> int:
    """Slots an expert in `_moe_dispatch` for ``t`` tokens."""
    e, k = config.num_experts, config.num_experts_per_tok
    return min(t, max(1, int(-(-t * k * config.expert_capacity_factor // e))))


def dispatch_slots(idx: torch.Tensor, e: int, cap: int):
    """Each (token, choice)'s slot in its expert's buffer, all first choices
    before any second: (slot ``[T, K]``, kept ``[T, K]``); a dropped pair's
    slot is ``cap``."""
    t, k = idx.shape
    mask = F.one_hot(idx, e).to(torch.int32)                 # [T, K, E]
    mask_flat = mask.transpose(0, 1).reshape(k * t, e)
    pos_flat = torch.cumsum(mask_flat, dim=0) - mask_flat
    pos = pos_flat.reshape(k, t, e).transpose(0, 1)           # [T, K, E]
    slot = (pos * mask).sum(dim=-1)
    kept = slot < cap
    return torch.where(kept, slot, torch.full_like(slot, cap)), kept


def _moe_dispatch(xt: torch.Tensor, layer: Dict[str, Any], config: ModelConfig,
                  kernels: bool = True, mesh=None):
    t, _ = xt.shape
    e = config.num_experts
    cap = capacity(t, config)
    probs, gate_vals, idx = route(xt, layer["router"], config)
    slot, kept = dispatch_slots(idx, e, cap)  # over all E: every rank alike
    dt = xt.dtype
    sel = F.one_hot(idx, e).to(dt) * kept[..., None].to(dt)          # [T, K, E]
    sel = sel[..., _rank_experts(layer, mesh)]                      # [T, K, E_local]
    slot_oh = F.one_hot(slot, cap + 1)[..., :cap].to(dt)            # [T, K, C]; dropped: 0
    dispatch = torch.einsum("tke,tkc->tec", sel, slot_oh)            # 0/1 [T, E, C]
    xin = torch.einsum("tec,th->ech", dispatch, xt)
    out = _expert_mlp(xin, layer, config, kernels, mesh)             # [E, C, H]
    combine = torch.einsum("tke,tkc,tk->tec", sel, slot_oh, gate_vals.to(dt))
    return _gated_sum("tec,ech->th", combine, out, mesh), _aux_loss(probs, idx, e)


def moe_ffn(x: torch.Tensor, layer: Dict[str, Any], config: ModelConfig, *,
            kernels: bool = True, mesh=None):
    """Sparse-MoE FFN of x ``[B, S, H]`` → (y, load-balancing loss); on a
    ``mesh``, this rank's experts and FFN width (the module docstring)."""
    b, s, h = x.shape
    xt = x.reshape(b * s, h)
    if b * s <= DENSE_TOKEN_CUTOFF:
        yt, aux = _moe_dense(xt, layer, config, kernels, mesh)
    else:
        yt, aux = _moe_dispatch(xt, layer, config, kernels, mesh)
    return yt.reshape(b, s, h).to(x.dtype), aux


def load_balancing_loss(xt: torch.Tensor, router: torch.Tensor,
                        config: ModelConfig) -> torch.Tensor:
    """Switch-transformer auxiliary loss of activations ``xt [..., H]``
    under ``router [H, E]``: E · Σ_e fraction_e · prob_e (1.0 when perfectly
    balanced, E when collapsed), recomputed from the activations as the
    JAX package's training loss may."""
    probs, _, idx = route(xt.reshape(-1, xt.shape[-1]), router, config)
    return _aux_loss(probs, idx, config.num_experts)
