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

On the train step's mesh (a `parallel.mesh.DifferentiableMesh`) the same
route carries the single device's gradients: the ep sum of the gated
outputs passes its gradient unchanged; the activation entering the rank's
experts sums its gradient over tp and ep (in f32, rounded once), and so do
the gates before the rank's experts are sliced out of them (each rank's
experts see part of the router's gradient); the router and the routing run
whole on every rank. With dp > 1 the routing is the whole batch's, as in
the JAX package's one program over the mesh (`_BatchRouting`): the scheme
and the capacity follow the whole batch's token count, each (token,
choice) takes its slot in the whole batch's k-major order, and the
load-balancing loss is this dp row's share of the whole batch's (the
shares sum over dp to it). One ``all_gather`` over dp of each row's
choice counts a layer gives all three. The inference route routes each dp
row's own rows.
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


def refuse_lora_experts(names) -> None:
    """Raise for LoRA on the expert stacks ``names`` (layer leaf names,
    "w1", "w3" or "w2"), naming the first: the JAX package's
    ``_expert_linear`` fails on a `LoraLinear` (it has no ``astype``), so
    the port has no such feature either."""
    for name in names:
        raise ValueError(f"['layers']['{name}']: LoRA on an MoE expert stack is not "
                         "supported (the JAX package's MoE cannot run it either); attach "
                         "adaptors to the attention projections")


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
        return linear_row_parallel(act, layer["w2"], mesh, kernels)
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


class _BatchRouting:
    """The routing's view of the whole batch: ``counts`` ``[dp, K, E]``,
    every dp row's count of choice j to expert e (this rank's rows alone
    where the routing is not over dp), ``row`` this dp row's place and
    ``tokens`` the whole batch's token count. Over dp its counts come from
    one ``all_gather`` (no gradient: they are integers)."""

    def __init__(self, idx: torch.Tensor, e: int, mesh, t: int):
        self.counts = F.one_hot(idx, e).sum(dim=0)[None]
        self.row, self.tokens = 0, t
        if whole_batch(mesh):
            self.counts = mesh.all_gather(self.counts, dim=0, axis="dp")
            self.row, self.tokens = mesh.index("dp"), t * mesh.dp

    @property
    def over_dp(self) -> bool:
        return self.counts.shape[0] > 1


def whole_batch(mesh) -> bool:
    """Whether ``mesh`` routes the whole batch over dp: the train step's
    differentiable mesh with dp > 1."""
    return mesh is not None and mesh.differentiable and mesh.dp > 1


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: int,
              routing: "_BatchRouting" = None) -> torch.Tensor:
    """Switch-transformer load-balancing loss: E · Σ_e fraction_e · prob_e.
    Over dp (``routing``) the fractions are the whole batch's and the
    probabilities this dp row's sum over the whole batch's token count:
    the row's share, whose gradient is the single device's for its tokens."""
    if routing is None or not routing.over_dp:
        counts = F.one_hot(idx, e).float().sum(dim=(0, 1))
        mean = probs.mean(dim=0)
    else:
        counts = routing.counts.sum(dim=(0, 1)).float()
        mean = probs.sum(dim=0) / routing.tokens
    fraction = counts / counts.sum().clamp_min(1.0)
    return e * (fraction * mean).sum()


def _gated_sum(spec: str, gates: torch.Tensor, outs: torch.Tensor, mesh) -> torch.Tensor:
    """The gate-weighted sum of the experts' outputs, in their dtype (one
    rounding of an f32-accumulated product). Over ep the rank's partial sum
    stays f32 and is summed over ep before that one rounding, so the result
    differs from the single device's only by the f32 sum's order."""
    if mesh is None or mesh.ep == 1:
        return torch.einsum(spec, gates, outs)
    part = torch.einsum(spec, gates.float(), outs.float())
    return mesh.all_reduce(part, axis="ep").to(outs.dtype)


def _expert_input(xt: torch.Tensor, mesh) -> torch.Tensor:
    """``xt`` as it enters the rank's experts: on the differentiable mesh
    its gradient, of which each rank's experts hold a part (their experts
    over ep, their FFN columns over tp), summed over tp and ep in f32 and
    rounded once (the identity on the inference route)."""
    if mesh is None or mesh.tp == 1 and mesh.ep == 1:
        return xt
    return mesh.sum_grad(mesh.sum_grad(xt.float()), "ep").to(xt.dtype)


def _gates_grad(gates: torch.Tensor, mesh) -> torch.Tensor:
    """The router's f32 gates (of every expert) before the rank's experts
    are sliced out of them: their gradient summed over ep."""
    return gates if mesh is None else mesh.sum_grad(gates, "ep")


def _moe_dense(xt: torch.Tensor, layer: Dict[str, Any], config: ModelConfig,
               kernels: bool = True, mesh=None):
    e = config.num_experts
    mine = _rank_experts(layer, mesh)
    probs, gate_vals, idx = route(xt, layer["router"], config)
    routing = _BatchRouting(idx, e, mesh, xt.shape[0]) if whole_batch(mesh) else None
    gates = _gates_grad(torch.zeros_like(probs).scatter(1, idx, gate_vals), mesh)[:, mine]
    xin = _expert_input(xt, mesh)
    outs = _expert_mlp(xin[None].expand(gates.shape[1], *xt.shape), layer, config, kernels,
                       mesh)  # [E_local, T, H]
    return _gated_sum("te,eth->th", gates.to(xt.dtype), outs, mesh), \
        _aux_loss(probs, idx, e, routing)


def capacity(t: int, config: ModelConfig) -> int:
    """Slots an expert in `_moe_dispatch` for ``t`` tokens."""
    e, k = config.num_experts, config.num_experts_per_tok
    return min(t, max(1, int(-(-t * k * config.expert_capacity_factor // e))))


def dispatch_slots(idx: torch.Tensor, e: int, cap: int, counts: torch.Tensor = None,
                   row: int = 0):
    """Each (token, choice)'s slot in its expert's buffer, all first choices
    before any second: (slot ``[T, K]``, kept ``[T, K]``); a dropped pair's
    slot is ``cap``. With ``counts`` (`_BatchRouting`'s ``[dp, K, E]``) and
    this dp row's place ``row``, the slot in the whole batch's k-major
    order: the pair's place among this row's choices j to its expert, after
    every choice below j to it on every row and choice j to it on the rows
    before this one."""
    mask = F.one_hot(idx, e)                                    # [T, K, E]
    if counts is None:
        counts = mask.sum(dim=0)[None]
    per_choice = counts.sum(dim=0)                              # [K, E]
    offset = torch.cumsum(per_choice, dim=0) - per_choice + counts[:row].sum(dim=0)
    pos = torch.cumsum(mask, dim=0) - mask + offset[None]       # [T, K, E]
    slot = (pos * mask).sum(dim=-1)
    kept = slot < cap
    return torch.where(kept, slot, torch.full_like(slot, cap)), kept


def _moe_dispatch(xt: torch.Tensor, layer: Dict[str, Any], config: ModelConfig,
                  kernels: bool = True, mesh=None):
    e = config.num_experts
    probs, gate_vals, idx = route(xt, layer["router"], config)
    routing = _BatchRouting(idx, e, mesh, xt.shape[0])
    cap = capacity(routing.tokens, config)
    # over all E: every rank alike
    slot, kept = dispatch_slots(idx, e, cap, routing.counts, routing.row)
    dt = xt.dtype
    sel = F.one_hot(idx, e).to(dt) * kept[..., None].to(dt)          # [T, K, E]
    sel = sel[..., _rank_experts(layer, mesh)]                      # [T, K, E_local]
    slot_oh = F.one_hot(slot, cap + 1)[..., :cap].to(dt)            # [T, K, C]; dropped: 0
    dispatch = torch.einsum("tke,tkc->tec", sel, slot_oh)            # 0/1 [T, E, C]
    xin = torch.einsum("tec,th->ech", dispatch, _expert_input(xt, mesh))
    out = _expert_mlp(xin, layer, config, kernels, mesh)             # [E, C, H]
    combine = torch.einsum("tke,tkc,tk->tec", sel, slot_oh,
                           _gates_grad(gate_vals, mesh).to(dt))
    return _gated_sum("tec,ech->th", combine, out, mesh), _aux_loss(probs, idx, e, routing)


def moe_ffn(x: torch.Tensor, layer: Dict[str, Any], config: ModelConfig, *,
            kernels: bool = True, mesh=None):
    """Sparse-MoE FFN of x ``[B, S, H]`` → (y, load-balancing loss); on a
    ``mesh``, this rank's experts and FFN width, and on the train step's
    mesh with dp > 1 the whole batch's routing and this dp row's share of
    the loss (the module docstring)."""
    b, s, h = x.shape
    xt = x.reshape(b * s, h)
    tokens = b * s * (mesh.dp if whole_batch(mesh) else 1)
    scheme = _moe_dense if tokens <= DENSE_TOKEN_CUTOFF else _moe_dispatch
    yt, aux = scheme(xt, layer, config, kernels, mesh)
    return yt.reshape(b, s, h).to(x.dtype), aux


def load_balancing_loss(xt: torch.Tensor, router: torch.Tensor,
                        config: ModelConfig) -> torch.Tensor:
    """Switch-transformer auxiliary loss of activations ``xt [..., H]``
    under ``router [H, E]``: E · Σ_e fraction_e · prob_e (1.0 when perfectly
    balanced, E when collapsed), recomputed from the activations as the
    JAX package's training loss may."""
    probs, _, idx = route(xt.reshape(-1, xt.shape[-1]), router, config)
    return _aux_loss(probs, idx, config.num_experts)
