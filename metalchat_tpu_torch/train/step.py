"""Training step: loss, partitioned gradients, optimizer update (port of the
JAX package's ``train/step.py``).

The parameter tree is *partitioned* into a flat trainable list and a flat
frozen list (quantized bases, rope tables, ...), so autograd forms no
gradient for a frozen leaf: QLoRA trains adaptors over frozen int8/int4
bases. The loss runs ``forward(..., differentiable=True)``: no CUDA kernel
is on the step's path (none defines a backward), the JAX package's route
with its Pallas kernels off. The optimizer is PyTorch's own, made by a
factory over the trainable list. The loss's tail and the optimizer's
update run under ``record_function`` ranges ("loss", "optimizer") that a
profiler can read.

With ``mesh`` (a `parallel.mesh.Mesh` over dp, ep and tp) the step is the
JAX package's one program over the ("dp", "ep", "tp") mesh, one process a
rank: every rank holds its local tree (`parallel.mesh.shard_params`: an MoE
model's experts over ep, their FFN width over tp) and the global batch;
each dp row trains on its contiguous rows of it (JAX's
``NamedSharding(P("dp"))``: the ep and tp ranks of a row take the same
rows), the forward runs the sharded differentiable route
(`models.transformer.forward(..., tp=mesh, differentiable=True)`; MoE routes
the whole batch, as the JAX package's one program does), the loss is the
global mean (each dp row's sum over the global mask count, and its share of
the load-balancing loss), the gradients are summed over dp, and the
optimizer updates each rank's local leaves: Adam, AdamW and SGD are
elementwise, so a rank holds the single device's slice. The metrics are
the same on every rank. The state records where its leaves sit
(`TrainLayout`); `gather_train_state` puts the whole leaves and moments
back together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.convert import optimizer_state_leaves, set_optimizer_state
from metalchat_tpu_torch.models.moe import refuse_lora_experts
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.parallel.mesh import (
    EXPERT_LEAVES,
    gather_leaf,
    leaf_ep_axis,
    leaf_tp_axis,
)
from metalchat_tpu_torch.parallel.tp_decode import _local_config
from metalchat_tpu_torch.train.tree import (
    DictKey,
    GetAttrKey,
    tree_flatten_with_path,
    tree_unflatten,
    treedef_paths,
)

PartitionSpec = Tuple[Any, Tuple[bool, ...]]  # (treedef, per-leaf trainable flag)


def trainable_lora(path, leaf) -> bool:
    """Trainable = LoRA adaptor leaves (fields .a / .b of LoraLinear)."""
    return any(isinstance(k, GetAttrKey) and k.name in ("a", "b") for k in path)


def trainable_full(path, leaf) -> bool:
    """Trainable = every floating-point weight except rope tables and
    quantized payloads (q/scales stay frozen; scales are not weights)."""
    if not torch.is_floating_point(leaf):
        return False
    keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
    return "rope" not in keys and "scales" not in keys


def partition(params: Dict[str, Any], pred: Callable) -> Tuple[List, List, PartitionSpec]:
    """Split a parameter tree into (trainable_leaves, frozen_leaves, spec),
    leaves in the JAX package's order (`train.tree`)."""
    with_path, treedef = tree_flatten_with_path(params)
    flags = tuple(bool(pred(path, leaf)) for path, leaf in with_path)
    trainable = [leaf for (_, leaf), f in zip(with_path, flags) if f]
    frozen = [leaf for (_, leaf), f in zip(with_path, flags) if not f]
    return trainable, frozen, (treedef, flags)


def combine(trainable: List, frozen: List, spec: PartitionSpec) -> Dict[str, Any]:
    """Rebuild the full parameter tree from the two partitions."""
    treedef, flags = spec
    it_t, it_f = iter(trainable), iter(frozen)
    return tree_unflatten(treedef, [next(it_t) if f else next(it_f) for f in flags])


def causal_lm_loss(params: Dict[str, Any], tokens: torch.Tensor, loss_mask: torch.Tensor,
                   config: ModelConfig, *, remat: bool = True,
                   moe_aux_weight: float = 0.0, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) over masked positions.

    tokens int ``[B, S]`` (inputs; the labels are tokens shifted by one),
    loss_mask ``[B, S-1]``. The forward writes k and v into a fresh bf16
    `KVCache` of S-1 positions, as the JAX package's loss does, so attention
    reads them rounded to bf16 whatever the parameters' dtype.
    ``moe_aux_weight > 0`` adds the router load-balancing loss (MoE models;
    Switch-transformer's default is about 0.01).

    With ``mesh`` the params are this rank's local tree, the rows this dp
    row's, and the loss this dp row's part of the global mean: its masked
    sum over the mask count of every dp row, plus ``moe_aux_weight`` times
    the forward's load-balancing term, which on such a mesh is this dp
    row's share of the whole batch's (`models.moe`), so that the term is
    counted once when the parts sum over dp to the single device's loss."""
    b, s = tokens.shape
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    cache_config = config if mesh is None else _local_config(config, mesh.tp)
    cache = KVCache.create(cache_config, b, s - 1, device=tokens.device)
    logits, _, aux = forward(params, cache, inputs, 0, config, remat=remat, with_aux=True,
                             differentiable=True, tp=mesh)
    with record_function("loss"):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        mask = loss_mask.float()
        count = mask.sum()
        if mesh is not None:
            count = mesh.all_reduce(count.detach().clone(), axis="dp")
        loss = (nll * mask).sum() / count.clamp_min(1.0)
        if moe_aux_weight:
            loss = loss + moe_aux_weight * aux
    return loss


@dataclass
class TrainLayout:
    """Where a sharded state's trainable leaves sit: the whole model's
    ``config``, the ``mesh``, each leaf's path in the parameter tree
    (`parallel.mesh.leaf_tp_axis` and `leaf_ep_axis` read its split from
    it) and the optimizer factory (for the gathered state's optimizer)."""
    config: ModelConfig
    mesh: Any
    paths: List[tuple]
    optimizer: Callable


@dataclass
class TrainState:
    trainable: List[torch.Tensor]  # flat list of trainable leaves (owned by the state)
    opt_state: torch.optim.Optimizer
    step: torch.Tensor             # int32, 0-d
    layout: Optional[TrainLayout] = None  # a sharded state's; None on one device


def moment_paths(n_moments: int, paths: List[tuple]) -> List[Optional[tuple]]:
    """The path of each optimizer-state leaf (`convert.optimizer_state_leaves`:
    Adam's count, then a first and a second moment a leaf; SGD's momentum a
    leaf; none for plain SGD), None for the count."""
    n = len(paths)
    if n_moments == 2 * n + 1:
        return [None, *paths, *paths]
    if n_moments == n:
        return list(paths)
    if n_moments:
        raise ValueError(f"{n_moments} optimizer-state leaves over {n} tensors")
    return []


def gather_train_state(state: TrainState) -> TrainState:
    """The whole train state of a sharded one (`make_train_step(mesh=...)`):
    every trainable leaf and optimizer moment put back together over tp and,
    for an expert stack, ep (`parallel.mesh.gather_leaf`: the split and the
    fused permutation undone), a new optimizer of the same kind over the
    whole leaves holding the gathered moments, the step count. Every rank of the mesh must call
    it, and every rank gets the same state; a state without a layout is
    returned as it is. The whole leaves combine with the whole tree's
    frozen partition (`combine`) for `merge_lora`, `quant.checkpoint`'s
    export and `save_train_state`."""
    lay = state.layout
    if lay is None:
        return state

    def gather(t, path):
        t = t.detach()
        return t.clone() if path is None else gather_leaf(t, path, lay.config, lay.mesh).clone()

    leaves = [gather(t, p).requires_grad_(True) for t, p in zip(state.trainable, lay.paths)]
    moments = optimizer_state_leaves(state.opt_state, state.trainable)
    moments = [gather(m, p) for m, p in zip(moments, moment_paths(len(moments), lay.paths))]
    opt = lay.optimizer(leaves)
    set_optimizer_state(opt, leaves, moments)
    return TrainState(leaves, opt, state.step.clone())


def _dp_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This dp row's contiguous rows of the global batch ``t``."""
    b = t.shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} rows does not divide over dp={mesh.dp}")
    n = b // mesh.dp
    return t[mesh.index("dp") * n:(mesh.index("dp") + 1) * n]


def _sum_over_dp(grads: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every gradient summed over dp: one all_reduce of them all in f32, each
    rounded back to its dtype (for two rows, a bf16 sum's own rounding)."""
    if mesh.dp == 1:
        return grads
    flat = mesh.all_reduce(torch.cat([g.float().reshape(-1) for g in grads]), axis="dp")
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return out


def _leaf_axes(path, config: ModelConfig, mesh) -> Tuple[str, ...]:
    """The mesh axes the leaf at ``path`` is split over: ("ep", "tp") for an
    expert stack split both ways, ("tp",), ("ep",) or () (whole)."""
    return tuple(a for a, f in (("ep", leaf_ep_axis), ("tp", leaf_tp_axis))
                 if f(path, config, getattr(mesh, a)) is not None)


def _global_norm(grads: List[torch.Tensor], axes: Optional[List[tuple]], mesh) -> torch.Tensor:
    """optax's ``global_norm``: the squared sums of the leaves split over tp
    summed over tp, an expert stack's over ep (and tp) too, a whole leaf's
    counted once."""
    sq = [g.float().square().sum() for g in grads]
    if axes is None or mesh.tp == 1 and mesh.ep == 1:
        return torch.sqrt(sum(sq))
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)

    def total(want):
        return sum((x for x, a in zip(sq, axes) if a == want), zero)

    tp_only, both = mesh.all_reduce(torch.stack([total(("tp",)), total(("ep", "tp"))])).unbind()
    ep_part = mesh.all_reduce((total(("ep",)) + both).clone(), axis="ep")
    return torch.sqrt(tp_only + ep_part + total(()))


def make_train_step(config: ModelConfig, optimizer: Callable[[List[torch.Tensor]], Any],
                    spec: PartitionSpec, *, remat: bool = True,
                    loss_fn: Optional[Callable] = None, mesh=None):
    """Build (init_state, step_fn).

    ``optimizer`` makes a ``torch.optim`` optimizer over a list of tensors,
    e.g. ``lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)``.
    Mind the defaults: ``optax.adamw``'s weight decay is 1e-4 and
    ``torch.optim.AdamW``'s 1e-2; Adam's betas and eps agree (0.9, 0.999,
    1e-8). The train-state files (`train.checkpoint`) hold Adam, AdamW and
    SGD (with or without momentum) in optax's layout.

    ``init_state(trainable)`` copies the leaves (the state owns them, and a
    tied head's view of the embedding becomes a leaf of its own, as in the
    JAX package) and makes the optimizer. ``step_fn(state, frozen, batch)
    -> (state, metrics)``; batch is a dict with "tokens" int ``[B, S]`` and
    "loss_mask" ``[B, S-1]`` (tensors or numpy arrays). The step updates
    the state's leaves in place; metrics are "loss", "grad_norm" (the
    global norm of the gradients) and "step". A trainable leaf the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it.

    ``mesh`` (a `parallel.mesh.Mesh` of dp × ep × tp; the module
    docstring) makes the sharded step: ``spec`` and the leaves are this
    rank's local tree's, the batch the global one (its rows divisible by
    dp), and ``loss_fn`` (if given) takes ``mesh=``. An MoE model trains
    with its experts over ep and their FFN width over tp; a `LoraLinear`
    on an expert stack is refused, naming the leaf (the JAX package's MoE
    fails on it)."""
    loss_of_params = loss_fn or causal_lm_loss
    paths = axes = None
    if mesh is not None:
        all_paths = treedef_paths(spec[0])
        if config.num_experts:  # a LoraLinear's fields under an expert stack's key
            refuse_lora_experts(p[1].key for p in all_paths if len(p) > 2
                                and p[0] == DictKey("layers") and p[1].key in EXPERT_LEAVES
                                and getattr(p[2], "name", None) in ("base", "a", "b"))
        paths = [p for p, f in zip(all_paths, spec[1]) if f]
        axes = [_leaf_axes(p, config, mesh) for p in paths]

    def init_state(trainable: List[torch.Tensor]) -> TrainState:
        leaves = [t.detach().clone().requires_grad_(True) for t in trainable]
        layout = None if mesh is None else TrainLayout(config, mesh, paths, optimizer)
        return TrainState(trainable=leaves, opt_state=optimizer(leaves),
                          step=torch.zeros((), dtype=torch.int32), layout=layout)

    def step_fn(state: TrainState, frozen: List, batch: Dict[str, Any]):
        dev = state.trainable[0].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        mask = torch.as_tensor(batch["loss_mask"]).to(dev)
        on_mesh = {}
        if mesh is not None:
            tokens, mask, on_mesh = _dp_rows(tokens, mesh), _dp_rows(mask, mesh), {"mesh": mesh}
        with torch.enable_grad():
            params = combine(state.trainable, frozen, spec)
            loss = loss_of_params(params, tokens, mask, config, remat=remat, **on_mesh)
            grads = torch.autograd.grad(loss, state.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.trainable, grads)]
        loss = loss.detach()
        if mesh is not None:
            grads = _sum_over_dp(grads, mesh)
            loss = mesh.all_reduce(loss.clone(), axis="dp")
        for p, g in zip(state.trainable, grads):
            p.grad = g
        grad_norm = _global_norm(grads, axes, mesh)
        with record_function("optimizer"):
            state.opt_state.step()
        step = state.step + 1
        metrics = {"loss": loss, "grad_norm": grad_norm, "step": step}
        return TrainState(state.trainable, state.opt_state, step, state.layout), metrics

    return init_state, step_fn
