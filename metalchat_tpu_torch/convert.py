"""Parameters handed across from the JAX package as numpy arrays.

``params_from_numpy`` turns a nested dict of numpy arrays into the port's
parameter tree, keeping every byte: a quantized leaf arrives as a dict
``{"q", "scales", "bits", "group_size", "transposed", "act_bits"}`` and
becomes a `QuantizedTensor` over the same packed bytes and scales, a LoRA
leaf as ``{"base", "a", "b", "scale"}`` becomes a `LoraLinear`; every
other leaf (Gemma-3's q/k and post norms, the local rope tables beside the
global ones, Mixtral's router) crosses as it is. Stacked leaves keep their
shapes, so Mixtral's ``[L, E, ...]`` expert stacks, dense or quantized (a 4-D
``q``), cross too. The tests use it so that both packages
compute on the same parameters.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

_QUANT_KEYS = {"q", "scales", "bits", "group_size", "transposed", "act_bits"}
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
        if isinstance(node, dict) and set(node) == _QUANT_KEYS:
            act = node["act_bits"]
            return QuantizedTensor(
                q=_tensor(node["q"], dev), scales=_tensor(node["scales"], dev),
                bits=int(node["bits"]), group_size=int(node["group_size"]),
                transposed=bool(node["transposed"]),
                act_bits=None if act is None else int(act))
        if isinstance(node, dict) and set(node) == _LORA_KEYS:
            return LoraLinear(base=conv(node["base"]), a=_tensor(node["a"], dev),
                              b=_tensor(node["b"], dev), scale=float(node["scale"]))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)
