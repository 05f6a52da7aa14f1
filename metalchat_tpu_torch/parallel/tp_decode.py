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

MoE rides the step on a mesh whose ep is 1 (JAX's ``moe_ok``): every rank
routes alike on the whole router and runs each routed expert at its FFN
width F/tp (the indexed matvec entry over the flattened ``[L·E]`` stack),
and the post-FFN ``all_reduce`` joins w2's partial sums. A mesh with ep > 1
is refused: its experts live on other ranks, and every window takes the
layer route (`layer_route_forward_fn`), as JAX's GSPMD path does.

The step runs collectives between its kernels: `engine.generate.DecodeStep`
and the serving engine's bursts run it eagerly (`tp_decode_forward_fn` marks
its function ``collectives = True``), on every backend.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.parallel.mesh import Mesh
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor


def tp_refusal(params: Dict[str, Any], config: ModelConfig, mesh: Mesh) -> Optional[str]:
    """Why the tensor-parallel decode cannot run this model on ``mesh``, or
    None when it can: the JAX package's gates (tp > 1; heads, kv-heads, FFN
    width and vocabulary divisible by tp; no biases; MoE experts stacked
    ``[L, E, ...]`` beside a router, on a mesh whose ep is 1; quantized
    leaves act8 per-channel; a fused leaf quantized, so that `shard_params`
    blocks it, or already blocked for this tp), and one of the port's own:
    no LoRA leaf (not ported under tp). ``params`` is the whole tree or a
    rank's local one."""
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
            return f"LoRA leaf {name}: adaptors under tp are not ported"
        if isinstance(leaf, QuantizedTensor) and not (
                leaf.act_bits == 8 and leaf.group_size == leaf.in_features):
            return (f"{name}: only act8 per-channel quantized leaves shard "
                    "(grouped scales run along the split contraction)")
    return None


def supports_tp_fast_decode(params: Dict[str, Any], config: ModelConfig,
                            mesh: Mesh) -> bool:
    """Whether the tensor-parallel decode can run this model on ``mesh``
    (`tp_refusal` gives the reason when not)."""
    return tp_refusal(params, config, mesh) is None


def _local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's shard: heads, kv-heads and FFN width over tp
    (the vocabulary and the hidden width stay)."""
    return replace(config, num_heads=config.num_heads // tp,
                   num_kv_heads=config.num_kv_heads // tp,
                   intermediate_size=config.intermediate_size // tp)


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
    `layer_route_forward_fn` for MoE over an expert-parallel mesh (JAX's
    GSPMD route); any other refusal raises ``ValueError`` with the reason
    (the port has no partitioned route for such a model)."""
    reason = tp_refusal(params, config, mesh)
    if reason is None:
        return tp_decode_forward_fn(params, config, mesh)
    if mesh.ep > 1 and config.num_experts:
        # The layer route's tp half needs what the tensor-parallel step does.
        reason = None if mesh.tp == 1 else tp_refusal(params, config, replace(mesh, ep=1))
        if reason is None:
            return layer_route_forward_fn(config, mesh)
    raise ValueError(f"spmd_mesh: {reason}; the port has no partitioned route for such "
                     "a model")
