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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.train.tree import (
    GetAttrKey,
    tree_flatten_with_path,
    tree_unflatten,
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
                   moe_aux_weight: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) over masked positions.

    tokens int ``[B, S]`` (inputs; the labels are tokens shifted by one),
    loss_mask ``[B, S-1]``. The forward writes k and v into a fresh bf16
    `KVCache` of S-1 positions, as the JAX package's loss does, so attention
    reads them rounded to bf16 whatever the parameters' dtype.
    ``moe_aux_weight > 0`` adds the router load-balancing loss (MoE models;
    Switch-transformer's default is about 0.01)."""
    b, s = tokens.shape
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    cache = KVCache.create(config, b, s - 1, device=tokens.device)
    logits, _, aux = forward(params, cache, inputs, 0, config, remat=remat, with_aux=True,
                             differentiable=True)
    with record_function("loss"):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        mask = loss_mask.float()
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        if moe_aux_weight:
            loss = loss + moe_aux_weight * aux
    return loss


@dataclass
class TrainState:
    trainable: List[torch.Tensor]  # flat list of trainable leaves (owned by the state)
    opt_state: torch.optim.Optimizer
    step: torch.Tensor             # int32, 0-d


def make_train_step(config: ModelConfig, optimizer: Callable[[List[torch.Tensor]], Any],
                    spec: PartitionSpec, *, remat: bool = True,
                    loss_fn: Optional[Callable] = None):
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
    does not reach gets a zero gradient, as ``jax.grad`` gives it."""
    loss_of_params = loss_fn or causal_lm_loss

    def init_state(trainable: List[torch.Tensor]) -> TrainState:
        leaves = [t.detach().clone().requires_grad_(True) for t in trainable]
        return TrainState(trainable=leaves, opt_state=optimizer(leaves),
                          step=torch.zeros((), dtype=torch.int32))

    def step_fn(state: TrainState, frozen: List, batch: Dict[str, Any]):
        dev = state.trainable[0].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        mask = torch.as_tensor(batch["loss_mask"]).to(dev)
        with torch.enable_grad():
            params = combine(state.trainable, frozen, spec)
            loss = loss_of_params(params, tokens, mask, config, remat=remat)
            grads = torch.autograd.grad(loss, state.trainable, allow_unused=True)
        for p, g in zip(state.trainable, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        grad_norm = torch.sqrt(sum(p.grad.float().square().sum() for p in state.trainable))
        with record_function("optimizer"):
            state.opt_state.step()
        step = state.step + 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "step": step}
        return TrainState(state.trainable, state.opt_state, step), metrics

    return init_state, step_fn
