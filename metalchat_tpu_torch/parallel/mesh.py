"""Device mesh and sharding rules (port of the JAX package's
``parallel/mesh.py``: its ("dp", "ep", "tp") mesh).

The JAX package places a global array on a device mesh and lets XLA (or
``shard_map``) work on the shards. Here every rank is a process of its own
that holds only its shard: `shard_params` and `shard_cache` return THIS
rank's local tree, the tree JAX's ``shard_map`` body sees after
``_localize_quant_metadata``.

Layout, the JAX package's ``param_shardings``:

* column-parallel over tp (out-features split): wq, wk, wv, w1, w3 and the
  fused wqkv / w13, dense or quantized (block-permuted first, with their
  fused biases, so that each rank's chunk is a standard fused leaf of its
  own heads and columns; segments that tp does not divide are refused; a
  wqkv whose kv-heads tp does not divide keeps the rank's query columns
  and every k and v column); their biases ``<name>_b`` split alike;
* row-parallel over tp (in-features split): wo, w2 (int4 leaves of either
  scheme repacked per chunk first, so that each rank's byte shard decodes
  to its own rows; group scales split with the codes, and a group that
  would straddle two ranks is refused); their biases whole;
* the embedding split by vocabulary rows, the lm_head by vocabulary
  columns; wk/wv (and the KV cache) whole when the kv-heads do not divide
  by tp, the embedding and lm_head whole when the vocabulary does not;
* a LoRA leaf's base as its kind says; its adaptors whole (JAX replicates
  them), but for ``b``'s columns of a column-parallel leaf and ``a``'s rows
  of a row-parallel one, which the rank's products need (the same
  function: `quant.quantize.linear_row_parallel` sums ``x·a`` over tp);
* MoE expert stacks (w1/w3 ``[L, E, H, F]``, w2 ``[L, E, F, H]``): the
  experts split over ep, the FFN width F over tp as above; the router whole;
* every other leaf (norms and their biases, rope tables, ``pos_emb``)
  whole on every rank, and every dense leaf whole over dp and ep.

Unlike JAX's GSPMD, which computes the single device's function on any
layout, the port's sharded layer route runs local kernels on each rank's
leaves, so the dense fused leaves and the weight-only int4 leaves are
laid out as the quantized act8 ones are.

`GridMesh` is one rank's view of a named grid of ranks (the pipeline's
("dp", "pp"), context parallelism's ("sp",), the mesh's ("dp", "ep", "tp")):
its place on each axis, the sub-group of the ranks along each axis through
it, and the point-to-point and collective moves that JAX's ``shard_map``
bodies make with ``ppermute``, ``psum`` and gathers (counted by kind).

`Mesh` is one rank's view of the ("dp", "ep", "tp") mesh: a `GridMesh` for
the layout and the dp and ep axes, and the tensor-parallel collectives the
sharded model code calls on its tp axis. Its collectives work in place and
carry no gradient; `Mesh.differentiable_view` gives the train step's mesh
(`DifferentiableMesh`), whose tp and ep collectives are autograd functions
at the places where the sharded route meets whole activations: a sum over
tp or ep whose gradient passes unchanged (row-parallel outputs, the
vocabulary-split embedding, the experts' gated sum over ep), a gather whose
gradient is this rank's slice (the vocabulary-split logits), and
`Mesh.sum_grad`, the identity whose gradient is summed over tp or ep (a
whole activation entering column-parallel work or the rank's experts, and a
whole leaf or activation, such as the router's gates, whose gradient each
rank sees only in part).

`leaf_tp_axis`, `leaf_ep_axis`, `gather_leaf` and `shard_leaf` place one
trainable leaf (named by its path in the parameter tree, `train.tree`)
between its whole form and a rank's part: the train state's gather and its
files.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Any, ClassVar, Dict, Optional

import numpy as np

import torch
import torch.distributed as dist

from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.fuse import _blocked_order, fused_segments
from metalchat_tpu_torch.quant.quantize import LoraLinear, QuantizedTensor, repack_int4_chunks

MESH_AXES = ("dp", "ep", "tp")
EXPERT_LEAVES = ("w1", "w3", "w2")
FUSED_LEAVES = ("wqkv", "w13", "wqkv_b", "w13_b")
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class GridMesh:
    """One rank's view of a grid of ranks with named axes, laid out row-major
    over ``shape`` as JAX's ``np.asarray(devices).reshape(...)``: on the
    pipeline's ``{"dp": D, "pp": P}`` rank r is stage ``r % P`` of dp row
    ``r // P``. ``rank`` is the rank in the grid's process group ``group``
    (None: the default group). ``groups`` holds, for each axis longer than
    one, the process group of the ranks along that axis through this rank
    (its pipeline for "pp", the ranks of its stage for "dp"). A grid of one
    rank needs no process group; a mesh built by hand with a rank and no
    groups describes that rank for the sharding functions, and its moves
    raise.

    Every move counts one under its kind and axis in ``counts``: ``shift``
    ("handoff" or "rotate"), ``broadcast``, ``all_gather``, ``all_reduce``,
    and ``broadcast_object`` over the whole grid. On gloo, which moves only
    host memory point to point, a CUDA tensor crosses through the host:
    ``backend`` (the process group's, recorded at `make_grid_mesh`) decides
    it, and each such move also counts one under "host_staged"."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[str, Any] = field(default_factory=dict)
    backend: str = ""
    counts: Counter = field(default_factory=Counter)
    group: Any = None

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
        """The grid's ranks along ``axis`` through this rank, in axis order."""
        axes = list(self.shape)
        if axis not in self.shape:
            return [self.rank]
        stride = 1
        for a in axes[axes.index(axis) + 1:]:
            stride *= self.shape[a]
        base = self.rank - self.index(axis) * stride
        return [base + i * stride for i in range(self.shape[axis])]

    def _global(self, rank: int) -> int:
        """The default group's rank of the grid's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

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
                             "(parallel.mesh.make_mesh or make_grid_mesh after initialize)")
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
            ops.append(dist.P2POp(dist.isend, self._wire(t), self._global(peers[(i + 1) % n]),
                                  group))
        if wrap or i > 0:
            staged = self.backend == "gloo" and t.is_cuda
            recv = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._global(peers[(i - 1) % n]), group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._count("rotate" if wrap else "handoff", axis, t)
        return torch.zeros_like(t) if recv is None else recv.to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str, src: int,
                  kind: str = "broadcast") -> torch.Tensor:
        """The ``t`` of the rank at place ``src`` along ``axis``, on every
        rank along it (a new tensor on ``t``'s device); counted under
        ``kind`` and the axis."""
        if self.size(axis) == 1:
            return t
        w = self._wire(t)
        dist.broadcast(w, src=self._global(self.peers(axis)[src]), group=self._group(axis))
        self._count(kind, axis, t)
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

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   kind: Optional[str] = None) -> torch.Tensor:
        """``t`` reduced over ``axis`` (``"sum"`` or ``"max"``) in its own
        dtype, the same on every rank along it; counted under ``kind``
        (default ``all_reduce_<op>``) and the axis."""
        if self.size(axis) == 1:
            return t
        w = self._wire(t)
        dist.all_reduce(w, op=_REDUCE_OPS[op], group=self._group(axis))
        self._count(kind or f"all_reduce_{op}", axis, t)
        return w.to(t.device)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """The grid's rank ``src``'s ``obj`` (picklable) on every rank of the
        grid."""
        if all(n == 1 for n in self.shape.values()):
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(src), group=self.group)
        self.counts["broadcast_object"] += 1
        return box[0]


def make_grid_mesh(shape: Dict[str, int], group: Any = None) -> GridMesh:
    """This process's view of the grid ``shape`` (axis name → size, in
    order) over ``group`` (None: the default group), whose size must be the
    grid's. An axis as long as the grid takes ``group`` itself; every rank
    creates the sub-groups of the shorter axes, in one order (which
    ``torch.distributed.new_group`` requires of every rank of the default
    group, so such an axis needs the default group). Without a process
    group up, a grid of one rank."""
    total = 1
    for n in shape.values():
        total *= n
    if not dist.is_initialized():
        if total != 1:
            raise ValueError(f"a {shape} mesh needs a process group of {total} ranks "
                             "(parallel.distributed.initialize)")
        return GridMesh(dict(shape))
    world = dist.get_world_size(group)
    if world != total:
        desc = " * ".join(f"{a}={n}" for a, n in shape.items())
        raise ValueError(f"{desc} = {total} != {world} processes in the group")
    short = [a for a, n in shape.items() if 1 < n < total]
    if short and group is not None:
        raise ValueError(f"axis {short[0]!r} of {shape} needs sub-groups, which every rank "
                         "of the default group must create: build this mesh on the default "
                         "group")
    mesh = GridMesh(dict(shape), rank=dist.get_rank(group), backend=dist.get_backend(group),
                    group=group)
    for axis, n in shape.items():
        if axis not in short:
            if n > 1:  # the whole grid
                mesh.groups[axis] = group
            continue
        for line in sorted({tuple(GridMesh(shape, rank=r).peers(axis)) for r in range(total)}):
            sub = dist.new_group(list(line))
            if mesh.rank in line:
                mesh.groups[axis] = sub
    return mesh


@dataclass
class Mesh:
    """One rank's view of a ("dp", "ep", "tp") grid of ``dp·ep·tp`` processes,
    laid out row-major as JAX's ``np.asarray(devices).reshape(dp, ep, tp)``:
    rank r sits at dp row ``r // (ep·tp)``, ep place ``(r // tp) % ep`` and
    tp place ``r % tp``. ``grid`` (a `GridMesh` over those axes, sharing
    ``counts``) owns the layout (`index`), each axis's process group and
    the dp and ep axes' collectives; ``group`` is the tp axis's process
    group (None: the default group), where the tensor-parallel code's
    collectives run, counted by kind alone. A mesh built by hand with a rank
    and no process group describes that rank: `shard_params` and
    `shard_cache` work on it, collectives raise."""

    tp: int = 1
    rank: int = 0
    group: Any = None
    counts: Counter = field(default_factory=Counter)
    dp: int = 1
    ep: int = 1
    grid: Optional[GridMesh] = None
    differentiable: ClassVar[bool] = False

    def __post_init__(self):
        if self.grid is None:
            self.grid = GridMesh(dict(zip(MESH_AXES, (self.dp, self.ep, self.tp))),
                                 rank=self.rank)
        self.grid.counts = self.counts

    @property
    def shape(self) -> Dict[str, int]:
        """The axes and their sizes, as JAX's ``mesh.shape`` (ep left out
        when it is 1)."""
        if self.ep > 1:
            return {"dp": self.dp, "ep": self.ep, "tp": self.tp}
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.ep * self.tp

    def index(self, axis: str) -> int:
        """This rank's place along ``axis``: "dp", "ep" or "tp"."""
        return self.grid.index(axis)

    def _reduce_tp(self, t: torch.Tensor, op: str, kind: str) -> torch.Tensor:
        t = t.contiguous()
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        self.counts[kind] += 1
        return t

    def _gather_tp(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t, group=self.group)
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: str = "tp") -> torch.Tensor:
        """``t`` reduced over ``axis`` (``"sum"`` or ``"max"``), in ``t``'s
        own dtype; on tp in place on a contiguous ``t``. Returns it."""
        if axis != "tp":
            return self.grid.all_reduce(t, axis, op)
        if self.tp == 1:
            return t
        return self._reduce_tp(t, op, f"all_reduce_{op}")

    def all_gather(self, t: torch.Tensor, dim: int = -1, axis: str = "tp") -> torch.Tensor:
        """Every rank's ``t`` along ``axis`` concatenated along ``dim`` in
        axis order (the same tensor on every rank along it)."""
        if axis != "tp":
            return self.grid.all_gather(t, axis, dim)
        if self.tp == 1:
            return t
        return self._gather_tp(t, dim)

    def sum_grad(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """``t`` itself: the inference route carries no gradient (the
        differentiable view sums ``t``'s gradient over ``axis``, "tp" or
        "ep")."""
        return t

    def differentiable_view(self) -> "DifferentiableMesh":
        """This mesh (its groups and ``counts`` shared) with tp collectives
        that autograd differentiates: `DifferentiableMesh`."""
        return DifferentiableMesh(**{f.name: getattr(self, f.name)
                                     for f in dataclasses.fields(self)})

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """The grid's rank ``src``'s ``obj`` (any picklable value) on every
        rank of the grid."""
        return self.grid.broadcast_object(obj, src)


class _SumGrad(torch.autograd.Function):
    """The identity; backward, the gradient summed over ``axis`` (counted
    ``all_reduce_sum_backward``, and ``_ep`` after it over ep)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis == "tp":
            return ctx.mesh._reduce_tp(g.clone(), "sum", "all_reduce_sum_backward"), None, None
        return ctx.mesh.grid.all_reduce(g.clone(), ctx.axis, kind="all_reduce_sum_backward"), \
            None, None


class _AllReduceEp(torch.autograd.Function):
    """The sum over ep; backward, the gradient unchanged (every ep rank's
    graph after the sum is the same, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.grid.all_reduce(t.clone(), "ep")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceTp(torch.autograd.Function):
    """The sum (or max) over tp; backward, the gradient unchanged (a max's
    to the ranks that hold it, shared evenly among them)."""

    @staticmethod
    def forward(ctx, t, mesh, op):
        ctx.mesh, ctx.op = mesh, op
        out = mesh._reduce_tp(t.clone(), op, f"all_reduce_{op}")
        if op == "max":
            ctx.save_for_backward(t, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        t, out = ctx.saved_tensors
        hit = (t == out).to(g.dtype)
        ranks = ctx.mesh._reduce_tp(hit.clone(), "sum", "all_reduce_sum_backward")
        return g * hit / ranks.clamp_min(1.0), None, None


class _AllGatherTp(torch.autograd.Function):
    """Every rank's part along ``dim``; backward, this rank's slice of the
    gradient (every rank computes the same function of the gathered whole)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.index, ctx.dim, ctx.size = mesh.index("tp"), dim % t.ndim, t.shape[dim]
        return mesh._gather_tp(t, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class DifferentiableMesh(Mesh):
    """The train step's view of a `Mesh` (`Mesh.differentiable_view`): its
    tp collectives, its sum over ep and `sum_grad` over tp or ep are
    autograd functions (the module docstring; the experts' route is
    `models.moe`'s); on the dp axis it is the mesh itself, carrying no
    gradient (the loss's parts and gradients are summed over dp outside
    autograd, `train.step`). Every rank runs the same backward pass, so the
    backward collectives (counted as ``all_reduce_sum_backward``, over ep
    ``all_reduce_sum_backward_ep``) meet in one order, a layer recomputed
    under remat included.

    A row's act8 absmax (a ``"max"``) sends its gradient to the ranks whose
    part holds the maximum, shared evenly among them and then among the
    rank's own tied elements: the single device's even share among every
    tied element of the row whenever the maximum is unique."""

    differentiable: ClassVar[bool] = True

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: str = "tp") -> torch.Tensor:
        if axis == "ep" and op == "sum" and self.ep > 1:
            return _AllReduceEp.apply(t, self)
        if axis != "tp" or self.tp == 1:
            return super().all_reduce(t, op, axis)
        return _AllReduceTp.apply(t, self, op)

    def all_gather(self, t: torch.Tensor, dim: int = -1, axis: str = "tp") -> torch.Tensor:
        if axis != "tp" or self.tp == 1:
            return super().all_gather(t, dim, axis)
        return _AllGatherTp.apply(t, self, dim)

    def sum_grad(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """``t``, whose gradient is summed over ``axis`` ("tp" or "ep") in
        the backward pass."""
        return t if getattr(self, axis) == 1 else _SumGrad.apply(t, self, axis)

    def differentiable_view(self) -> "DifferentiableMesh":
        return self


def make_mesh(tp: Optional[int] = None, dp: int = 1, ep: int = 1, group: Any = None) -> Mesh:
    """This process's view of a ("dp", "ep", "tp") mesh over ``group`` (None:
    the default group), the JAX package's ``make_mesh``: ``tp`` defaults to
    the group's size over dp·ep, and dp·ep·tp must be that size. The axes'
    process groups are `make_grid_mesh`'s (an axis shorter than the grid
    needs the default group). Without a process group up, a mesh of one
    rank."""
    up = dist.is_initialized()
    n = dist.get_world_size(group) if up else 1
    if tp is None:
        tp = n // (dp * ep)
    if dp * ep * tp != n:
        msg = f"dp*ep*tp = {dp}*{ep}*{tp} != {n} devices"
        if not up:
            msg += " (no process group: parallel.distributed.initialize)"
        raise ValueError(msg)
    if not up:
        return Mesh(tp=1, rank=0, group=group)
    grid = make_grid_mesh(dict(zip(MESH_AXES, (dp, ep, tp))), group)
    return Mesh(tp=tp, dp=dp, ep=ep, rank=grid.rank, group=grid.groups.get("tp", group),
                grid=grid)


def _check_divisibility(config: ModelConfig, tp: int) -> None:
    for name, value in (("num_heads", config.num_heads),
                        ("intermediate_size", config.intermediate_size)):
        if value % tp:
            raise ValueError(f"{name}={value} not divisible by tp={tp}")


def _check_ep(config: ModelConfig, ep: int) -> None:
    if not config.num_experts:
        raise ValueError("mesh has an ep axis but the model has no experts")
    if config.num_experts % ep:
        raise ValueError(f"num_experts={config.num_experts} not divisible by ep={ep}")


def _rules(config: ModelConfig, tp: int) -> Dict[str, Optional[str]]:
    """Which logical axis each leaf splits on over tp: "out" (column-parallel,
    and a column-parallel leaf's bias), "in" (row-parallel: for the
    embedding, its vocabulary rows), or absent (whole)."""
    kv = "out" if config.num_kv_heads % tp == 0 else None
    vocab = config.vocab_size % tp == 0
    rules = {"embed": "in" if vocab else None, "lm_head": "out" if vocab else None,
             "wq": "out", "wqkv": "out", "w13": "out", "w1": "out", "w3": "out",
             "wk": kv, "wv": kv, "wo": "in", "w2": "in"}
    rules.update({f"{n}_b": "out" for n, r in list(rules.items()) if r == "out"})
    return rules


def _fused_columns(name: str, config: ModelConfig, tp: int, rank: int) -> torch.Tensor:
    """The whole fused leaf ``name``'s out-axis columns that the rank at tp
    place ``rank`` holds, in its local order: its chunk of the ``fuse_tp``
    block order (a standard fused leaf of its own heads or FFN columns;
    segments that tp does not divide are refused), or, for a ``wqkv`` whose
    kv-heads tp does not divide, its own query heads' columns followed by
    every k and v column (wk and wv whole)."""
    segs = fused_segments(name, config)
    if name == "wqkv" and config.num_kv_heads % tp:
        q = segs[0] // tp
        return torch.cat([torch.arange(rank * q, (rank + 1) * q),
                          torch.arange(segs[0], sum(segs))])
    if any(s % tp for s in segs):
        raise ValueError(f"fused {name}: segments {segs} not divisible by tp={tp} (the "
                         "ranks' chunks would mix q with k rows or gate with up columns)")
    order = torch.from_numpy(_blocked_order(segs, tp))
    n = order.numel() // tp
    return order[rank * n:(rank + 1) * n]


def _check_groups(leaf: QuantizedTensor, name: str, tp: int) -> None:
    """A row-parallel group-wise leaf: every rank holds whole groups (and an
    int4 rank's half-split packing whole groups of its own rows)."""
    if leaf.group_size == leaf.in_features:
        return
    local = leaf.in_features // tp
    need = 2 * leaf.group_size if leaf.bits == 4 else leaf.group_size
    if leaf.in_features % tp or local % need:
        raise ValueError(f"{name}: in_features/tp = {leaf.in_features}/{tp} is not a multiple "
                         f"of {need} (group_size {leaf.group_size}"
                         f"{', int4 half-split' if leaf.bits == 4 else ''}): a group would "
                         "straddle two ranks")


def _split(t: torch.Tensor, axis: int, parts: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``t`` cut into ``parts`` contiguous parts along
    ``axis``, a copy of its own (so that the whole tensor can be freed)."""
    n = t.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} not divisible into {parts} parts")
    part = n // parts
    return t.narrow(axis, index * part, part).clone(memory_format=torch.contiguous_format)


def _local(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/tp of ``t`` along ``axis``, at its tp place."""
    return _split(t, axis, mesh.tp, mesh.index("tp"))


def _shard_quantized(leaf: QuantizedTensor, rule: str, name: str, config: ModelConfig,
                     mesh: Mesh) -> QuantizedTensor:
    tp = mesh.tp
    if rule == "in":
        _check_groups(leaf, name, tp)
    if leaf.bits == 4 and rule == "in" and leaf.q.ndim > 2:
        # One leading entry (layer, expert) at a time: the repack's unpacked
        # copy stays the size of one entry, not of the whole stack.
        parts = [_shard_quantized(leaf.layer(i), rule, name, config, mesh)
                 for i in range(leaf.q.shape[0])]
        return replace(parts[0], q=torch.stack([p.q for p in parts]),
                       scales=torch.stack([p.scales for p in parts]))
    per_channel = leaf.group_size == leaf.in_features
    out_axis, in_axis = (-2, -1) if leaf.transposed else (-1, -2)
    if name in ("wqkv", "w13") and leaf.fuse_tp != tp or \
            name == "wqkv" and config.num_kv_heads % tp:  # the rank's columns
        if leaf.fuse_tp != 1:
            raise ValueError(f"fused {name} blocked for tp={leaf.fuse_tp}: re-blocking is "
                             "not supported")
        cols = _fused_columns(name, config, tp, mesh.index("tp")).to(leaf.q.device)
        q = leaf.q.index_select(leaf.q.ndim + out_axis, cols)
        # scales [.., 1, out], [.., out, in/g] transposed, [.., in/g, out] not
        scales = leaf.scales.index_select(leaf.scales.ndim + (-1 if per_channel else out_axis),
                                          cols)
    else:
        if leaf.bits == 4 and rule == "in":
            leaf = repack_int4_chunks(leaf, tp)
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
    if rule is None or mesh.tp == 1:
        return leaf
    if isinstance(leaf, LoraLinear):  # the adaptors' own rows or columns
        base = _shard_leaf(leaf.base, rule, name, config, mesh)
        if rule == "out":
            return replace(leaf, base=base, b=_local(leaf.b, -1, mesh))
        return replace(leaf, base=base, a=_local(leaf.a, -2, mesh))
    if isinstance(leaf, QuantizedTensor) and name == "embed":  # row-quantized: [V, ...] rows
        return replace(leaf, q=_local(leaf.q, 0, mesh), scales=_local(leaf.scales, 0, mesh))
    if isinstance(leaf, QuantizedTensor):
        return _shard_quantized(leaf, rule, name, config, mesh)
    if name in FUSED_LEAVES:  # dense fused weights and biases: the rank's columns
        cols = _fused_columns(name.removesuffix("_b"), config, mesh.tp, mesh.index("tp"))
        return leaf.index_select(leaf.ndim - 1, cols.to(leaf.device))
    return _local(leaf, -1 if rule == "out" else -2, mesh)


def _local_experts(leaf: Any, mesh: Mesh) -> Any:
    """This rank's experts (axis 1 of an ``[L, E, ...]`` stack) at its ep
    place; a quantized stack's codes and scales alike."""
    if isinstance(leaf, QuantizedTensor):
        return replace(leaf, q=_split(leaf.q, 1, mesh.ep, mesh.index("ep")),
                       scales=_split(leaf.scales, 1, mesh.ep, mesh.index("ep")))
    return _split(leaf, 1, mesh.ep, mesh.index("ep"))


def shard_params(params: Dict[str, Any], config: ModelConfig, mesh: Mesh) -> Dict[str, Any]:
    """This rank's local parameter tree (the module docstring's layout).
    Its quantized leaves have the standard layout for the local shapes
    (``pack_chunks`` 1, ``fuse_tp`` 1, a row-parallel per-channel leaf's
    ``group_size`` its local in-features): the bytes of the JAX package's
    ``shard_params`` shard on device ``rank``. Split leaves are copies, so
    the caller may free the whole tree; whole leaves are shared with it."""
    if mesh.tp == 1 and mesh.ep == 1:
        return params
    if mesh.tp > 1:
        _check_divisibility(config, mesh.tp)
    if mesh.ep > 1:
        _check_ep(config, mesh.ep)
    rules = _rules(config, mesh.tp)
    out = {k: _shard_leaf(v, rules.get(k), k, config, mesh) for k, v in params.items()
           if k != "layers"}
    layers = {}
    for k, v in params["layers"].items():
        if mesh.ep > 1 and k in EXPERT_LEAVES:  # the experts first: less to repack
            v = _local_experts(v, mesh)
        layers[k] = _shard_leaf(v, rules.get(k), k, config, mesh)
    out["layers"] = layers
    return out


def shard_cache(cache, mesh: Mesh):
    """This rank's local cache, as the JAX package's ``cache_partition_specs``
    and ``paged_cache_partition_specs`` shard it: a dense or int8 cache
    (``[L, B, nkv, S, hd]``, scales ``[L, B, nkv, S]``) its batch rows over
    dp and its kv-heads over tp; a paged cache its pools' kv-heads over tp
    (``[L, nkv, P, ps, hd]``, scales ``[L, P, nkv, ps]``) and its page
    table's rows over dp. The kv-heads stay whole when they do not divide by
    tp. Split tensors are copies; a cache with nothing to split is returned
    as it is."""
    if isinstance(cache, PagedKVCache):
        nkv = cache.k_pages.shape[1]
        heads, rows = {"k_pages": 1, "v_pages": 1, "k_scale": 2, "v_scale": 2}, \
            {"page_table": 0}
    elif isinstance(cache, (KVCache, QuantizedKVCache)):
        nkv = cache.k.shape[2]
        heads = {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2}
        rows = dict.fromkeys(heads, 1)
    else:
        raise TypeError(f"not a cache: {type(cache).__name__}")
    tp = mesh.tp if nkv % mesh.tp == 0 else 1
    if tp == 1 and mesh.dp == 1:
        return cache

    def local(name, t):
        if name in rows and mesh.dp > 1:
            t = _split(t, rows[name], mesh.dp, mesh.index("dp"))
        if name in heads and tp > 1:
            t = _split(t, heads[name], tp, mesh.index("tp"))
        return t.clone() if t is getattr(cache, name) else t

    return type(cache)(**{f.name: local(f.name, getattr(cache, f.name))
                          for f in dataclasses.fields(cache)})


def _path_keys(path) -> list:
    return [getattr(k, "key", getattr(k, "name", None)) for k in path]


def leaf_tp_axis(path, config: ModelConfig, tp: int) -> Optional[int]:
    """The axis (negative) along which `shard_params` splits the dense leaf
    at ``path`` (a `train.tree` path: ``['layers']['wq']``,
    ``['layers']['wo'].a``, ``['embed']``) over ``tp`` ranks, or None where
    every rank holds it whole: a column-parallel leaf and its bias on their
    out axis, a row-parallel one on its in axis, the embedding on its
    vocabulary rows, a LoRA leaf's ``b`` (column-parallel) or ``a``
    (row-parallel). A quantized payload (``q``, ``scales``) is refused: it
    is frozen, never trained."""
    keys = _path_keys(path)
    if keys[-1] in ("q", "scales"):
        raise ValueError(f"{''.join(map(str, path))}: a quantized payload has no trained "
                         "layout")
    if tp == 1:
        return None
    name = keys[1] if keys[0] == "layers" else keys[0]
    rule = _rules(config, tp).get(name)
    attr = getattr(path[-1], "name", None)  # a LoRA leaf's field
    if rule is None or attr == "a" and rule == "out" or attr == "b" and rule == "in":
        return None
    return -1 if rule == "out" else -2


def leaf_ep_axis(path, config: ModelConfig, ep: int) -> Optional[int]:
    """The axis (negative) along which `shard_params` splits the leaf at
    ``path`` over ``ep`` ranks: an MoE expert stack's expert axis (w1/w3
    ``[L, E, H, F]``, w2 ``[L, E, F, H]``: JAX's ``P(None, "ep", ...)``), or
    None (every other leaf, the router included, is whole over ep)."""
    keys = _path_keys(path)
    if ep == 1 or not config.num_experts or keys[0] != "layers" or len(keys) != 2 \
            or keys[1] not in EXPERT_LEAVES:
        return None
    return -3


def shard_leaf(t: torch.Tensor, path, config: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the whole dense leaf ``t`` at ``path``, as
    `shard_params` cuts it: an expert stack's experts at the rank's ep place
    first, then its tp part (a fused leaf's columns `_fused_columns`)."""
    ep_axis = leaf_ep_axis(path, config, mesh.ep)
    if ep_axis is not None:
        t = _split(t, ep_axis, mesh.ep, mesh.index("ep"))
    axis = leaf_tp_axis(path, config, mesh.tp)
    if axis is None:
        return t
    name = _path_keys(path)[1] if _path_keys(path)[0] == "layers" else None
    if name in FUSED_LEAVES:
        cols = _fused_columns(name.removesuffix("_b"), config, mesh.tp, mesh.index("tp"))
        return t.index_select(t.ndim - 1, cols.to(t.device))
    return _local(t, axis, mesh)


def gather_leaf(t: torch.Tensor, path, config: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """The whole dense leaf at ``path`` from every rank's part ``t`` (one
    ``all_gather`` over tp where it is split, then one over ep for an
    expert stack; `shard_leaf` undone, a fused leaf's columns put back in
    place). Every rank along those axes must call it."""
    ep_axis = leaf_ep_axis(path, config, mesh.ep)
    axis = leaf_tp_axis(path, config, mesh.tp)
    if axis is not None:
        t = mesh.all_gather(t, dim=axis)
    if ep_axis is not None:
        t = mesh.all_gather(t, dim=ep_axis, axis="ep")
    name = _path_keys(path)[1] if _path_keys(path)[0] == "layers" else None
    if axis is None or name not in FUSED_LEAVES:
        return t
    base = name.removesuffix("_b")
    cols = torch.cat([_fused_columns(base, config, mesh.tp, r) for r in range(mesh.tp)])
    whole = t.new_empty(*t.shape[:-1], sum(fused_segments(base, config)))
    whole[..., cols.to(t.device)] = t
    return whole
