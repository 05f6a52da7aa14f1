"""Tensor-parallel mesh and sharding rules (port of the JAX package's
``parallel/mesh.py``, its ``tp`` axis).

The JAX package places a global array on a device mesh and lets XLA (or
``shard_map``) work on the shards. Here every rank is a process of its own
that holds only its shard: `shard_params` and `shard_cache` return THIS
rank's local tree, the tree JAX's ``shard_map`` body sees after
``_localize_quant_metadata``.

Layout, the JAX package's ``param_shardings`` on a ``tp`` axis:

* column-parallel (out-features split): wq, wk, wv, w1, w3 and the fused
  wqkv / w13 (quantized fused leaves block-permuted first, so that each
  rank's chunk is a standard fused leaf of its own heads and columns);
* row-parallel (in-features split): wo, w2 (int4 act8 leaves repacked per
  chunk first, so that each rank's byte shard decodes to its own rows);
* the embedding split by vocabulary rows, the lm_head by vocabulary
  columns; wk/wv (and the KV cache) whole when the kv-heads do not divide
  by tp, the embedding and lm_head whole when the vocabulary does not;
* every other leaf (norms, rope tables, biases, a LoRA leaf's adaptors)
  whole on every rank.

`Mesh` is one rank's view of its group: the process group, the rank, tp,
and the collectives the tensor-parallel code calls (counted by kind).

`GridMesh` is one rank's view of a named grid of ranks, the pipeline's
("dp", "pp") and context parallelism's ("sp",): its place on each axis,
the sub-group of the ranks along each axis through it, and the
point-to-point and collective moves that JAX's ``shard_map`` bodies make
with ``ppermute``, ``psum`` and gathers (counted by kind, as `Mesh`'s).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.fuse import fused_segments, permute_fused_tp
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor, repack_int4_chunks

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class Mesh:
    """One rank's view of a tensor-parallel group of ``tp`` processes.
    ``group`` None is the default process group. A mesh of tp > 1 with no
    process group up describes a rank without talking to the others:
    `shard_params` and `shard_cache` work on it, collectives raise.
    ``counts`` tallies the collectives called, by kind."""

    tp: int = 1
    rank: int = 0
    group: Any = None
    counts: Counter = field(default_factory=Counter)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (``"sum"`` or ``"max"``), in ``t``'s
        own dtype, in place on a contiguous ``t``; returns it."""
        if self.tp == 1:
            return t
        t = t.contiguous()
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        self.counts[f"all_reduce_{op}"] += 1
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        same tensor on every rank)."""
        if self.tp == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t, group=self.group)
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` (any picklable value) on every rank."""
        if self.tp == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        self.counts["broadcast"] += 1
        return box[0]


def make_mesh(tp: Optional[int] = None, group: Any = None) -> Mesh:
    """This process's mesh over ``group`` (None: the default group). ``tp``
    defaults to the group's size and must equal it: only the tp axis is
    ported. Without a process group up, a mesh of one rank."""
    if not dist.is_initialized():
        if tp not in (None, 1):
            raise ValueError(f"tp={tp} needs a process group of {tp} ranks "
                             "(parallel.distributed.initialize)")
        return Mesh(tp=1, rank=0, group=group)
    size = dist.get_world_size(group)
    tp = size if tp is None else tp
    if tp != size:
        raise ValueError(f"tp={tp} != {size} processes in the group (only tp is ported)")
    return Mesh(tp=tp, rank=dist.get_rank(group), group=group)


@dataclass
class GridMesh:
    """One rank's view of a grid of ranks with named axes, laid out row-major
    over ``shape`` as JAX's ``np.asarray(devices).reshape(...)``: on the
    pipeline's ``{"dp": D, "pp": P}`` rank r is stage ``r % P`` of dp row
    ``r // P``. ``groups`` holds, for each axis longer than one, the
    process group of the ranks along that axis through this rank (its
    pipeline for "pp", the ranks of its stage for "dp"). A grid of one rank
    needs no process group; a mesh built by hand with a rank and no groups
    describes that rank for the sharding functions, and its moves raise.

    Every move counts one under its kind and axis in ``counts``: ``shift``
    ("handoff" or "rotate"), ``broadcast``, ``all_gather``, and
    ``broadcast_object`` over the whole grid. On gloo, which moves only
    host memory point to point, a CUDA tensor crosses through the host:
    ``backend`` (the process group's, recorded at `make_grid_mesh`) decides
    it, and each such move also counts one under "host_staged"."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[str, Any] = field(default_factory=dict)
    backend: str = ""
    counts: Counter = field(default_factory=Counter)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for axis in reversed(list(self.shape)):
            rank, out[axis] = divmod(rank, self.shape[axis])
        return out

    def index(self, axis: str) -> int:
        """This rank's place along ``axis`` (0 on an axis the grid lacks)."""
        return self._coords(self.rank).get(axis, 0)

    def peers(self, axis: str):
        """The global ranks along ``axis`` through this rank, in axis order."""
        axes = list(self.shape)
        if axis not in self.shape:
            return [self.rank]
        stride = 1
        for a in axes[axes.index(axis) + 1:]:
            stride *= self.shape[a]
        base = self.rank - self.index(axis) * stride
        return [base + i * stride for i in range(self.shape[axis])]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as handed to torch.distributed: contiguous, and in host
        memory for a CUDA tensor on gloo."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def _count(self, kind: str, axis: str, t: torch.Tensor) -> None:
        self.counts[f"{kind}_{axis}"] += 1
        if self.backend == "gloo" and t.is_cuda:
            self.counts["host_staged"] += 1

    def _group(self, axis: str):
        if axis not in self.groups:
            raise ValueError(f"axis {axis!r} of this mesh has no process group "
                             "(parallel.mesh.make_grid_mesh after initialize)")
        return self.groups[axis]

    def shift(self, t: torch.Tensor, axis: str, *, wrap: bool) -> torch.Tensor:
        """Every rank sends ``t`` to the next rank along ``axis`` and returns
        what the previous one sent: JAX's ``ppermute`` with pairs (i, i+1),
        the pipeline's hand-off (``wrap=False``: the first rank receives
        zeros, the last sends nothing), or (i, (i+1) % n), the ring's
        rotation (``wrap=True``). Every rank along the axis must call it."""
        n, i = self.size(axis), self.index(axis)
        if n == 1:
            return t if wrap else torch.zeros_like(t)
        peers, group = self.peers(axis), self._group(axis)
        ops, recv = [], None
        if wrap or i + 1 < n:
            ops.append(dist.P2POp(dist.isend, self._wire(t), peers[(i + 1) % n], group))
        if wrap or i > 0:
            staged = self.backend == "gloo" and t.is_cuda
            recv = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
            ops.append(dist.P2POp(dist.irecv, recv, peers[(i - 1) % n], group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._count("rotate" if wrap else "handoff", axis, t)
        return torch.zeros_like(t) if recv is None else recv.to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """The ``t`` of the rank at place ``src`` along ``axis``, on every
        rank along it (a new tensor on ``t``'s device)."""
        if self.size(axis) == 1:
            return t
        w = self._wire(t)
        dist.broadcast(w, src=self.peers(axis)[src], group=self._group(axis))
        self._count("broadcast", axis, t)
        return w.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``axis`` concatenated on ``dim`` in axis
        order (the same tensor on every rank along it)."""
        n = self.size(axis)
        if n == 1:
            return t
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=self._group(axis))
        self._count("all_gather", axis, t)
        return torch.cat(parts, dim=dim).to(t.device)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` (picklable) on every rank of the grid."""
        if all(n == 1 for n in self.shape.values()):
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        self.counts["broadcast_object"] += 1
        return box[0]


def make_grid_mesh(shape: Dict[str, int]) -> GridMesh:
    """This process's view of the grid ``shape`` (axis name → size, in
    order) over the default process group, whose size must be the grid's.
    Every rank creates every axis's sub-groups, in one order (which
    ``torch.distributed.new_group`` requires). Without a process group up,
    a grid of one rank."""
    total = 1
    for n in shape.values():
        total *= n
    if not dist.is_initialized():
        if total != 1:
            raise ValueError(f"a {shape} mesh needs a process group of {total} ranks "
                             "(parallel.distributed.initialize)")
        return GridMesh(dict(shape))
    world = dist.get_world_size()
    if world != total:
        desc = " * ".join(f"{a}={n}" for a, n in shape.items())
        raise ValueError(f"{desc} = {total} != {world} processes in the group")
    mesh = GridMesh(dict(shape), rank=dist.get_rank(), backend=dist.get_backend())
    for axis, n in shape.items():
        if n == 1:
            continue
        lines = sorted({tuple(GridMesh(dict(shape), rank=r).peers(axis))
                        for r in range(total)})
        for line in lines:
            group = dist.new_group(list(line))
            if mesh.rank in line:
                mesh.groups[axis] = group
    return mesh


def _check_divisibility(config: ModelConfig, tp: int) -> None:
    for name, value in (("num_heads", config.num_heads),
                        ("intermediate_size", config.intermediate_size)):
        if value % tp:
            raise ValueError(f"{name}={value} not divisible by tp={tp}")


def _rules(config: ModelConfig, tp: int) -> Dict[str, Optional[str]]:
    """Which logical axis each leaf splits on: "out" (column-parallel),
    "in" (row-parallel: for the embedding, its vocabulary rows), or absent
    (whole)."""
    kv = "out" if config.num_kv_heads % tp == 0 else None
    vocab = config.vocab_size % tp == 0
    return {"embed": "in" if vocab else None, "lm_head": "out" if vocab else None,
            "wq": "out", "wqkv": "out", "w13": "out", "w1": "out", "w3": "out",
            "wk": kv, "wv": kv, "wo": "in", "w2": "in"}


def _local(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/tp of ``t`` along ``axis``, a copy of its own
    (so that the whole tensor can be freed)."""
    n = t.shape[axis]
    if n % mesh.tp:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} not divisible by tp={mesh.tp}")
    part = n // mesh.tp
    return t.narrow(axis, mesh.rank * part, part).clone(memory_format=torch.contiguous_format)


def _shard_quantized(leaf: QuantizedTensor, rule: str, name: str, config: ModelConfig,
                     mesh: Mesh) -> QuantizedTensor:
    tp = mesh.tp
    if name in ("wqkv", "w13"):
        segs = fused_segments(name, config)
        if not any(s % tp for s in segs):
            leaf = permute_fused_tp(leaf, segs, tp)
    if leaf.bits == 4 and leaf.act_bits == 8 and rule == "in":
        leaf = repack_int4_chunks(leaf, tp)
    per_channel = leaf.group_size == leaf.in_features
    out_axis, in_axis = (-2, -1) if leaf.transposed else (-1, -2)
    q = _local(leaf.q, out_axis if rule == "out" else in_axis, mesh)
    if per_channel:  # scales [.., 1, out]
        scales = _local(leaf.scales, -1, mesh) if rule == "out" else leaf.scales
    else:            # [.., out, in/g] transposed, [.., in/g, out] not
        scales = _local(leaf.scales, out_axis if rule == "out" else in_axis, mesh)
    local = replace(leaf, q=q, scales=scales, pack_chunks=1, fuse_tp=1)
    if per_channel:
        local = replace(local, group_size=local.in_features)
    return local


def _shard_leaf(leaf: Any, rule: Optional[str], name: str, config: ModelConfig,
                mesh: Mesh) -> Any:
    if rule is None:
        return leaf
    if isinstance(leaf, LoraLinear):  # adaptors whole, as JAX replicates them
        return replace(leaf, base=_shard_leaf(leaf.base, rule, name, config, mesh))
    if isinstance(leaf, QuantizedTensor):
        return _shard_quantized(leaf, rule, name, config, mesh)
    return _local(leaf, -1 if rule == "out" else -2, mesh)


def shard_params(params: Dict[str, Any], config: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """This rank's local parameter tree (the module docstring's layout).
    Its quantized leaves have the standard layout for the local shapes
    (``pack_chunks`` 1, ``fuse_tp`` 1, a row-parallel per-channel leaf's
    ``group_size`` its local in-features): the bytes of the JAX package's
    ``shard_params`` shard on device ``rank``. Split leaves are copies, so
    the caller may free the whole tree; whole leaves are shared with it."""
    if mesh.tp == 1:
        return params
    _check_divisibility(config, mesh.tp)
    rules = _rules(config, mesh.tp)
    out = {k: _shard_leaf(v, rules.get(k), k, config, mesh) for k, v in params.items()
           if k != "layers"}
    out["layers"] = {k: _shard_leaf(v, rules.get(k), k, config, mesh)
                     for k, v in params["layers"].items()}
    return out


def shard_cache(cache, mesh: Mesh):
    """This rank's local cache: its kv-heads of a dense or int8 cache
    (``[L, B, nkv, S, hd]``), or of a paged cache's pools (``[L, nkv, P,
    ps, hd]``, scales ``[L, P, nkv, ps]``) with the page table whole, as the
    JAX package's tp decode shards them. Whole when the kv-heads do not
    divide by tp. The local tensors are copies."""
    if mesh.tp == 1:
        return cache
    if isinstance(cache, PagedKVCache):
        nkv, axes = cache.k_pages.shape[1], {"k_pages": 1, "v_pages": 1, "k_scale": 2,
                                              "v_scale": 2}
    elif isinstance(cache, (KVCache, QuantizedKVCache)):
        nkv, axes = cache.k.shape[2], {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2}
    else:
        raise TypeError(f"not a cache: {type(cache).__name__}")
    if nkv % mesh.tp:
        return cache
    return type(cache)(**{
        f.name: (_local(getattr(cache, f.name), axes[f.name], mesh) if f.name in axes
                 else getattr(cache, f.name).clone())
        for f in dataclasses.fields(cache)})
