"""Parameter trees flattened in the JAX package's leaf order, with paths.

`partition`, `combine` and the train-state files pair leaves by index, so
the order is the JAX package's (``jax.tree_util``): a dict by sorted key, a
list or tuple in order, a `QuantizedTensor` as its data fields (q, scales)
and a `LoraLinear` as (base, a, b); None holds no leaf. A path is a tuple
of `DictKey`, `SequenceKey` and `GetAttrKey`, which print as JAX's key
types do (``keystr``: ``['layers']['wq'].a``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Tuple

from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor

DATA_FIELDS = {QuantizedTensor: ("q", "scales"), LoraLinear: ("base", "a", "b")}


@dataclass(frozen=True)
class DictKey:
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclass(frozen=True)
class SequenceKey:
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclass(frozen=True)
class GetAttrKey:
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def keystr(path) -> str:
    return "".join(str(k) for k in path)


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """([(path, leaf)], treedef) in the JAX package's order."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k], path + (DictKey(k),)) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), [walk(c, path + (SequenceKey(i),)) for i, c in enumerate(node)])
        fields = DATA_FIELDS.get(type(node))
        if fields is not None:
            return ("fields", node, fields,
                    [walk(getattr(node, f), path + (GetAttrKey(f),)) for f in fields])
        out.append((path, node))
        return ("leaf",)

    treedef = walk(tree, ())
    return out, treedef


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "fields":
            return dataclasses.replace(d[1], **{f: build(c) for f, c in zip(d[2], d[3])})
        return kind(build(c) for c in d[1])

    tree = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def treedef_paths(treedef) -> List[tuple]:
    """The leaf paths of ``treedef`` (`tree_flatten_with_path`'s), in
    flattening order."""
    out: List[tuple] = []

    def walk(d, path):
        kind = d[0]
        if kind == "leaf":
            out.append(path)
        elif kind == "dict":
            for k, c in zip(d[1], d[2]):
                walk(c, path + (DictKey(k),))
        elif kind == "fields":
            for f, c in zip(d[2], d[3]):
                walk(c, path + (GetAttrKey(f),))
        elif kind != "none":
            for i, c in enumerate(d[1]):
                walk(c, path + (SequenceKey(i),))

    walk(treedef, ())
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]
