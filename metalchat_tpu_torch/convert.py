"""Parameters handed across from the JAX package as numpy arrays.

``params_from_numpy`` turns a nested dict of numpy arrays into the port's
parameter tree, keeping every byte: a quantized leaf arrives as a dict
``{"q", "scales", "bits", "group_size", "transposed", "act_bits"}`` (and
``"pack_chunks"`` / ``"fuse_tp"`` where a tensor-parallel layout set them)
and becomes a `QuantizedTensor` over the same packed bytes and scales with
the same layout fields, a LoRA
leaf as ``{"base", "a", "b", "scale"}`` becomes a `LoraLinear`; every
other leaf (Gemma-3's q/k and post norms, the local rope tables beside the
global ones, Mixtral's router) crosses as it is. Stacked leaves keep their
shapes, so Mixtral's ``[L, E, ...]`` expert stacks, dense or quantized (a 4-D
``q``), cross too. The tests use it so that both packages
compute on the same parameters.

``optimizer_state_leaves`` and ``set_optimizer_state`` carry a PyTorch
optimizer's state across in optax's layout, the leaves that the JAX
package's train-state files hold after the trainable list: Adam and AdamW
as ``ScaleByAdamState`` (the update count, int32, then every first moment,
then every second moment), SGD with momentum as ``TraceState`` (every
momentum buffer) and plain SGD as no leaf at all.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

_QUANT_KEYS = {"q", "scales", "bits", "group_size", "transposed", "act_bits"}
_TP_KEYS = {"pack_chunks", "fuse_tp"}
_LORA_KEYS = {"base", "a", "b", "scale"}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays (and quantized-leaf dicts) → port params."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict) and _QUANT_KEYS <= set(node) <= _QUANT_KEYS | _TP_KEYS:
            act = node["act_bits"]
            return QuantizedTensor(
                q=_tensor(node["q"], dev), scales=_tensor(node["scales"], dev),
                bits=int(node["bits"]), group_size=int(node["group_size"]),
                transposed=bool(node["transposed"]),
                act_bits=None if act is None else int(act),
                pack_chunks=int(node.get("pack_chunks", 1)),
                fuse_tp=int(node.get("fuse_tp", 1)))
        if isinstance(node, dict) and set(node) == _LORA_KEYS:
            return LoraLinear(base=conv(node["base"]), a=_tensor(node["a"], dev),
                              b=_tensor(node["b"], dev), scale=float(node["scale"]))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def _optimizer_kind(opt) -> str:
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        if any(g.get("amsgrad") for g in opt.param_groups):
            raise NotImplementedError("amsgrad has no optax state layout here")
        return "adam"
    if isinstance(opt, torch.optim.SGD):
        return "trace" if any(g.get("momentum") for g in opt.param_groups) else "sgd"
    raise NotImplementedError(f"no optax state layout for {type(opt).__name__}")


def optimizer_state_leaves(opt, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``opt``'s state over ``params`` as optax's state leaves (zeros before
    the first step, as ``optimizer.init`` makes them)."""
    kind = _optimizer_kind(opt)
    if kind == "sgd":
        return []
    states = [opt.state.get(p, {}) for p in params]
    if kind == "trace":
        return [s.get("momentum_buffer", torch.zeros_like(p)) for s, p in zip(states, params)]
    count = int(states[0]["step"]) if states and "step" in states[0] else 0
    return [torch.tensor(count, dtype=torch.int32),
            *[s.get("exp_avg", torch.zeros_like(p)) for s, p in zip(states, params)],
            *[s.get("exp_avg_sq", torch.zeros_like(p)) for s, p in zip(states, params)]]


def set_optimizer_state(opt, params: Sequence[torch.Tensor], leaves) -> None:
    """Replace ``opt``'s state over ``params`` by optax's state leaves
    ``leaves`` (tensors or numpy arrays, as `optimizer_state_leaves` lists
    them)."""
    kind = _optimizer_kind(opt)
    n = len(params)
    want = {"sgd": 0, "trace": n, "adam": 2 * n + 1}[kind]
    if len(leaves) != want:
        raise ValueError(f"{type(opt).__name__} over {n} tensors takes {want} state "
                         f"leaves, got {len(leaves)}")

    def like(leaf, p):
        t = leaf if torch.is_tensor(leaf) else _tensor(np.asarray(leaf), p.device)
        return t.detach().reshape(p.shape).to(device=p.device, dtype=p.dtype).clone()

    if kind == "trace":
        for p, leaf in zip(params, leaves):
            opt.state[p] = {"momentum_buffer": like(leaf, p)}
    elif kind == "adam":
        count = float(torch.as_tensor(leaves[0]).reshape(()))
        for i, p in enumerate(params):
            # torch keeps the step as a CPU f32 tensor unless fused or capturable
            opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                            "exp_avg": like(leaves[1 + i], p),
                            "exp_avg_sq": like(leaves[1 + n + i], p)}
