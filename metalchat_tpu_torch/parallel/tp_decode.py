"""Tensor-parallel decode (port of the JAX package's
``parallel/tp_decode.py``).

The JAX package runs its single-chip decode kernels under ``shard_map`` with
the collectives written out by hand. Here every rank is a process that holds
its local tree (`parallel.mesh.shard_params`) and its local cache
(`parallel.mesh.shard_cache`), and runs the same hand-written kernels at the
local shapes (`models.decode.decode_step(..., tp=mesh)`):

* column-parallel wqkv / w1 / w3 read the whole hidden row: no collective;
* attention at the rank's kv-heads and their query groups: no collective;
* row-parallel wo and w2: one ``all_reduce`` each of the ``[B, H]`` partial
  sums, in the activation dtype (JAX's ``psum``);
* the embedding split by vocabulary rows (a masked local lookup, one
  ``all_reduce``), the lm_head by vocabulary columns, the whole logits
  assembled on every rank (one ``all_gather``, the same bytes on every rank).

Activation quantization of a row-parallel matvec runs per shard, as in JAX's
``shard_map`` body: each rank scales its own slice of the contraction, a
finer scheme than the single device's per-token scale. Column-parallel
matvecs see the whole row and give the single device's codes. Prompts and
every window that is not one token take the tensor-parallel layer route
(`models.transformer.forward(..., tp=mesh)`), which computes the single
device's function (JAX's GSPMD prefill).

The step needs kv-heads that tp divides (JAX's fast-decode gate); the
layer route keeps kv-heads that tp does not divide whole on every rank, as
JAX's GSPMD replicates wk, wv and the cache, and each rank's query heads
read theirs (`rank_kv_heads`).

MoE rides the step on a mesh whose ep is 1 (JAX's ``moe_ok``): every rank
routes alike on the whole router and runs each routed expert at its FFN
width F/tp (the indexed matvec entry over the flattened ``[L·E]`` stack),
and the post-FFN ``all_reduce`` joins w2's partial sums. A mesh with ep > 1
is refused: its experts live on other ranks.

Every tree the step refuses (grouped weight-only leaves, biases, dense
fused leaves, LoRA leaves, MoE over ep, a vocabulary tp does not divide)
takes the sharded layer route at every window (`layer_route_forward_fn`),
as JAX's engine pins ``forward(fast_decode=False)`` on sharded params for
GSPMD: `spmd_forward_fn` makes that choice. JAX's gate takes a LoRA leaf
on an act8 base, but its ``shard_map`` body then adds whole adaptors to
local shapes and raises (a ``TypeError`` on the CPU mesh); the port refuses
LoRA on the step and serves such trees on the layer route.

The step runs collectives between its kernels: `engine.generate.DecodeStep`
and the serving engine's bursts run it eagerly (`tp_decode_forward_fn` marks
its function ``collectives = True``), on every backend.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import Mesh, _check_divisibility, _check_ep
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor


def tp_refusal(params: Dict[str, Any], config: ModelConfig, mesh: Mesh) -> Optional[str]:
    """Why the tensor-parallel decode cannot run this model on ``mesh``, or
    None when it can: the JAX package's gates (tp > 1; heads, kv-heads, FFN
    width and vocabulary divisible by tp; no biases; MoE experts stacked
    ``[L, E, ...]`` beside a router, on a mesh whose ep is 1; quantized
    leaves act8 per-channel; a fused leaf quantized, so that `shard_params`
    blocks it, or already blocked for this tp), and one of the port's own:
    no LoRA leaf (JAX's gate takes one on an act8 base, and its step then
    raises: the module docstring). ``params`` is the whole tree or a rank's
    local one."""
    tp = mesh.tp
    layers = params.get("layers", {})
    if tp < 2:
        return f"tp={tp}: tensor parallelism needs at least 2 ranks"
    for name in ("num_heads", "num_kv_heads", "intermediate_size", "vocab_size"):
        if getattr(config, name) % tp:
            return f"{name}={getattr(config, name)} not divisible by tp={tp}"
    if config.use_bias:
        return "biases are added once after the all_reduce; use_bias is not supported"
    if config.num_experts:
        from metalchat_tpu_torch.models.decode import _moe_ok

        if not _moe_ok(params, config):
            return "MoE experts must be stacked [L, E, ...] beside a router"
        if mesh.ep > 1:
            return (f"ep={mesh.ep}: an expert-parallel mesh takes the layer route (the fast "
                    "decode holds every expert's tp-shard)")
    for name in ("wqkv", "w13"):
        leaf = layers.get(name)
        if leaf is not None and not (isinstance(leaf, QuantizedTensor)
                                     and leaf.fuse_tp in (1, tp)):
            return (f"fused {name} must be a QuantizedTensor that shard_params blocks for "
                    f"tp={tp} (a dense fused leaf mixes q with k rows across ranks)")
    for name, leaf in layers.items():
        if isinstance(leaf, LoraLinear):
            return (f"LoRA leaf {name}: the fast decode's step would add whole adaptors to "
                    "local shapes (JAX's raises); LoRA trees take the layer route")
        if isinstance(leaf, QuantizedTensor) and not (
                leaf.act_bits == 8 and leaf.group_size == leaf.in_features):
            return (f"{name}: only act8 per-channel quantized leaves shard "
                    "(grouped scales run along the split contraction)")
    return None


def layer_route_refusal(config: ModelConfig, mesh: Mesh) -> Optional[str]:
    """Why the sharded layer route cannot run this model on ``mesh``, or
    None: where `parallel.mesh.shard_params` refuses the config (heads and
    FFN width divisible by tp, the experts by ep). kv-heads that tp does not
    divide stay whole on every rank, as JAX's GSPMD replicates them
    (`rank_kv_heads`). Leaf-level refusals (groups that straddle ranks,
    fused segments) are `shard_params`' own."""
    try:
        if mesh.tp > 1:
            _check_divisibility(config, mesh.tp)
        if mesh.ep > 1:
            _check_ep(config, mesh.ep)
    except ValueError as err:
        return str(err)
    return None


def supports_tp_fast_decode(params: Dict[str, Any], config: ModelConfig,
                            mesh: Mesh) -> bool:
    """Whether the tensor-parallel decode can run this model on ``mesh``
    (`tp_refusal` gives the reason when not)."""
    return tp_refusal(params, config, mesh) is None


def _local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's shard: heads and FFN width over tp, the
    kv-heads over tp where tp divides them and whole where it does not (the
    vocabulary and the hidden width stay)."""
    nkv = config.num_kv_heads
    return replace(config, num_heads=config.num_heads // tp,
                   num_kv_heads=nkv if nkv % tp else nkv // tp,
                   intermediate_size=config.intermediate_size // tp)


def rank_kv_heads(config: ModelConfig, mesh) -> Optional[tuple]:
    """The kv-head that each of this rank's query heads reads, where tp does
    not divide the kv-heads (they stay whole on every rank), or None where
    the rank's kv-heads are its own. The rank at tp place i holds query
    heads ``[i·H/tp, (i+1)·H/tp)``; head h reads kv-head ``h // (H/nkv)``."""
    tp = 1 if mesh is None else mesh.tp
    if config.num_kv_heads % tp == 0:
        return None
    local = config.num_heads // tp
    group = config.num_heads // config.num_kv_heads
    first = mesh.index("tp") * local
    return tuple((first + j) // group for j in range(local))


def make_tp_decode_step(params: Dict[str, Any], config: ModelConfig, mesh: Mesh):
    """``step(params, cache, tokens, start_pos) → (logits, cache)``: the
    tensor-parallel `decode_step` on this rank's local ``params`` and
    ``cache`` (dense, int8 or paged: `decode_step` reads the kind from the
    cache, where the JAX package's ``cache_quantized`` and ``paged`` set its
    partition specs), the whole f32 logits ``[B, S, V]`` on every rank.
    ``params`` (the whole tree or a local one) is checked here; an
    ineligible model raises ``ValueError`` with the reason."""
    from metalchat_tpu_torch.models.decode import decode_step

    reason = tp_refusal(params, config, mesh)
    if reason is not None:
        raise ValueError(f"model/mesh not eligible for tp fast decode: {reason}")

    def step(p, cache, tokens, start_pos):
        return decode_step(p, cache, tokens, start_pos, config, tp=mesh)

    return step


def tp_decode_forward_fn(params: Dict[str, Any], config: ModelConfig, mesh: Mesh):
    """The engine's ``forward_fn(params, cache, tokens, start_pos) →
    (logits, cache)`` under tensor parallelism: one-token steps take
    `make_tp_decode_step`, every other window the tensor-parallel layer
    route (``forward(..., tp=mesh)``). The function carries ``collectives =
    True``, which sends `DecodeStep` and the engine's bursts to their eager
    route."""
    from metalchat_tpu_torch.models.transformer import forward

    tp_step = make_tp_decode_step(params, config, mesh)

    def fwd(p, cache, tokens, start_pos):
        if tokens.shape[1] == 1:
            return tp_step(p, cache, tokens, start_pos)
        return forward(p, cache, tokens, start_pos, config, tp=mesh)

    fwd.collectives = True
    return fwd


def layer_route_forward_fn(config: ModelConfig, mesh: Mesh):
    """The ``forward_fn`` of the sharded layer route: every window, one
    token included, through ``forward(..., tp=mesh)`` (JAX's GSPMD forward
    on sharded params, whose ``supports_fast_decode`` is false). It carries
    ``collectives = True``."""
    from metalchat_tpu_torch.models.transformer import forward

    def fwd(p, cache, tokens, start_pos):
        return forward(p, cache, tokens, start_pos, config, tp=mesh)

    fwd.collectives = True
    return fwd


def spmd_forward_fn(params: Dict[str, Any], config: ModelConfig, mesh: Mesh):
    """The forward a rank of ``mesh`` runs, as the JAX engine picks it:
    `tp_decode_forward_fn` where the tensor-parallel decode takes the model,
    otherwise `layer_route_forward_fn` (JAX's ``forward(fast_decode=False)``
    on sharded params): grouped weight-only, biased, dense fused and LoRA
    trees, MoE over ep, a vocabulary tp does not divide, and a mesh whose
    tp is 1 (dp or ep only). Raises ``ValueError`` with the reason only where
    the layer route cannot run the model (`layer_route_refusal`)."""
    if tp_refusal(params, config, mesh) is None:
        return tp_decode_forward_fn(params, config, mesh)
    reason = layer_route_refusal(config, mesh)
    if reason is not None:
        raise ValueError(f"spmd_mesh: {reason}")
    return layer_route_forward_fn(config, mesh)
