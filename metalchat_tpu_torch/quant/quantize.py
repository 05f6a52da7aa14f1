"""Weight quantization and the quantized linear (port of the JAX package's
``quant/quantize.py``).

Packing and scales are computed with the same numpy arithmetic as the JAX
package, so both produce the same bytes from the same weights:

* int4 is packed half-split along in-features with an offset-binary low
  nibble: byte ``r`` holds ``w[r] + 8`` (low) and ``w[r + in/2]`` (high,
  two's complement);
* ``transposed=False`` stores ``q [(L,) in(/2), out]``, scales
  ``[(L,) in/g, out]``; ``transposed=True`` stores ``q [(L,) out, in(/2)]``,
  scales ``[(L,) out, in/g]``; per-channel scales stay ``[(L,) 1, out]`` in
  both orientations.

Two execution schemes:

* ``act_bits=8`` with per-channel scales: activations are quantized per
  token to int8 and the product runs as s8×s8→s32 with one post-scale.
  `linear` serves more than 16 rows with an exact integer matrix product
  (``torch._int_mm`` on the card); decode windows call the CUDA matvec
  kernel from ``models/decode.py``.
* weight-only (``act_bits=None``), group-wise or per-channel: `linear`
  sends up to 32 rows to the dequant-matmul kernel (``ops/quant_matmul.py``)
  and more rows to the weight dequantized in the activation dtype and
  ``torch.matmul`` (the JAX package leaves that large product to XLA).

A `LoraLinear` leaf is a base linear (quantized or dense) plus a low-rank
adaptor, the reference's QLoRA layer: `linear` runs the base as above, then
adds ``scale · (x·A)·B`` in the activation dtype (two products, each rounded,
then the scaled sum: the JAX package's order).

Embeddings may be row-quantized (``quantize_params(quantize_embed=True)``):
the table ``[V, H]`` is stored row-major, ``q [V, H(/2)]`` and scales
``[V, H/g]`` with groups along H, and `lookup_embedding` dequantizes only the
gathered rows.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.ops.a8_matvec import act_quantize, int_dot
from metalchat_tpu_torch.ops.quant_matmul import (
    dequant_matmul,
    dequant_weight,
    supported as dequant_kernel_supported,
)


@dataclass
class QuantizedTensor:
    """Groupwise-quantized 2-D weight; leaves may carry a leading stacked
    layer axis ``[L, ...]``."""

    q: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    group_size: int = 32
    transposed: bool = False
    act_bits: Optional[int] = None
    # int4 packing granularity: the half-split pairing runs within each of
    # ``pack_chunks`` equal chunks of the in-features axis (1 is the standard
    # packing). `parallel.mesh.shard_params` repacks a row-parallel int4
    # leaf per rank (`repack_int4_chunks`), so that each rank's contiguous
    # byte shard is a standard packing of its own logical rows.
    pack_chunks: int = 1
    # Fused-projection tp blocking: with ``fuse_tp`` > 1 the out axis of a
    # fused wqkv / w13 is block-permuted (`models.fuse.permute_fused_tp`), so
    # that each contiguous 1/fuse_tp chunk holds one rank's [q_i|k_i|v_i]
    # ([gate_i|up_i]); `models.fuse.split_fused(..., blocks=fuse_tp)`
    # splits its output.
    fuse_tp: int = 1

    @property
    def in_features(self) -> int:
        n = self.q.shape[-1] if self.transposed else self.q.shape[-2]
        return n * 2 if self.bits == 4 else n

    @property
    def out_features(self) -> int:
        return self.q.shape[-2] if self.transposed else self.q.shape[-1]

    def layer(self, l: int) -> "QuantizedTensor":
        """Layer ``l`` of a stacked leaf (views, no copy)."""
        return replace(self, q=self.q[l], scales=self.scales[l])


@dataclass
class LoraLinear:
    """A base linear plus a low-rank adaptor, ``y = base(x) + scale·(x·A)·B``
    (the reference's QLoRA layer; LoRA scale 2.0 by default). ``base`` is a
    `QuantizedTensor` or a dense ``[(L,) in, out]`` tensor; ``a [(L,) in,
    rank]``, ``b [(L,) rank, out]``."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    scale: float = 2.0

    def layer(self, l: int) -> "LoraLinear":
        """Layer ``l`` of a stacked leaf (views, no copy)."""
        base = self.base.layer(l) if isinstance(self.base, QuantizedTensor) else self.base[l]
        return replace(self, base=base, a=self.a[l], b=self.b[l])


def _pack_int4(w4):
    """Pack int4 values [-8, 7] along the in axis (-2), two per byte,
    half-split with an offset-binary low nibble. A numpy array or a torch
    tensor (packed where it lies)."""
    if torch.is_tensor(w4):
        w4 = w4.to(torch.int16)
    half = w4.shape[-2] // 2
    lo = (w4[..., :half, :] + 8) & 0x0F
    hi = (w4[..., half:, :] & 0x0F) << 4
    packed = lo | hi
    return packed.to(torch.int8) if torch.is_tensor(packed) else packed.astype(np.int8)


def _unpack_int4(packed: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """int8 ``[..., in/2, out]`` → the signed nibbles ``[..., in, out]``;
    with ``chunks`` > 1 the half-split pairing runs within each of
    ``chunks`` equal ranges of the packed axis (``pack_chunks``)."""
    lo = (packed & 15) - 8
    hi = packed >> 4  # arithmetic: the high nibble is two's complement
    if chunks == 1:
        return torch.cat([lo, hi], dim=-2)
    *lead, half, out = packed.shape
    lo = lo.reshape(*lead, chunks, half // chunks, out)
    hi = hi.reshape(*lead, chunks, half // chunks, out)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * half, out)


def _packed_in_rows(qt: "QuantizedTensor") -> torch.Tensor:
    """``q`` with its packed axis at -2 (a view)."""
    return qt.q.transpose(-1, -2) if qt.transposed else qt.q


def _with_packed(qt: "QuantizedTensor", packed: torch.Tensor, chunks: int) -> "QuantizedTensor":
    q = packed.transpose(-1, -2) if qt.transposed else packed
    return replace(qt, q=q.contiguous(), pack_chunks=chunks)


def repack_int4_chunks(qt: "QuantizedTensor", chunks: int) -> "QuantizedTensor":
    """The same int4 weight packed per chunk (``pack_chunks = chunks``), on
    the device where it lies: only the pairing of bytes with logical rows
    moves, so a contiguous 1/chunks byte shard becomes a standard packing
    of its own logical in-range (the JAX package's numpy steps, the same
    bytes)."""
    if qt.bits != 4 or chunks == qt.pack_chunks:
        return qt
    if qt.pack_chunks != 1:
        raise ValueError("repack from non-default chunking not supported")
    packed = _packed_in_rows(qt)
    *lead, half, out = packed.shape
    if half % (2 * chunks):
        raise ValueError(f"packed axis {half} not splittable into {chunks} half-split chunks")
    w4 = _unpack_int4(packed).reshape(*lead, chunks, 2 * half // chunks, out)
    return _with_packed(qt, _pack_int4(w4).reshape(*lead, half, out), chunks)


def standard_packing(qt: "QuantizedTensor") -> "QuantizedTensor":
    """``qt`` with the standard int4 packing (``pack_chunks = 1``)."""
    if qt.bits != 4 or qt.pack_chunks == 1:
        return qt
    return _with_packed(qt, _pack_int4(_unpack_int4(_packed_in_rows(qt), qt.pack_chunks)), 1)


def quantize(w, bits: int = 8, group_size: Optional[int] = 32,
             scales_dtype=torch.float32, transposed: bool = False,
             act_bits: Optional[int] = None, clip_search: bool = False,
             device=None) -> QuantizedTensor:
    """Symmetric groupwise quantization of an ``[(L,) in, out]`` weight.

    ``group_size=None`` gives per-output-channel scales, which the
    ``act_bits=8`` scheme requires. ``clip_search`` replaces each group's
    absmax scale by the one of 11 clip ratios (1.0 down to 0.5) with the
    least squared reconstruction error over the group, as the JAX package
    searches (the same numpy steps, so the same bytes)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if act_bits not in (None, 8):
        raise ValueError(f"act_bits must be None or 8, got {act_bits}")
    if torch.is_tensor(w):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    in_features, out_features = w.shape[-2:]
    if group_size is None:
        group_size = in_features
    if act_bits is not None and group_size != in_features:
        raise ValueError("act_bits=8 needs per-channel scales (group_size=None)")
    if in_features % group_size:
        raise ValueError(f"in_features={in_features} not divisible by group={group_size}")
    if bits == 4 and group_size != in_features and (in_features // 2) % group_size:
        raise ValueError("int4 needs in_features/2 divisible by the group size")
    g = w.reshape(*w.shape[:-2], in_features // group_size, group_size, out_features)
    qmax = 127.0 if bits == 8 else 7.0
    scales = np.abs(g).max(axis=-2, keepdims=True) / qmax
    if clip_search:
        best_err = np.full(scales.shape, np.inf, np.float32)
        best = scales.copy()
        for ratio in np.linspace(1.0, 0.5, 11):
            s = scales * np.float32(ratio)
            with np.errstate(divide="ignore"):
                inv = np.where(s == 0.0, 0.0, 1.0 / s)
            codes = np.clip(np.round(g * inv), -qmax, qmax)
            err = ((codes * s - g) ** 2).sum(axis=-2, keepdims=True)
            best = np.where(err < best_err, s, best)
            best_err = np.minimum(err, best_err)
        scales = best
    with np.errstate(divide="ignore"):  # all-zero groups: inv 0, codes 0
        inv = np.where(scales == 0.0, 0.0, 1.0 / scales)
    q = np.clip(np.round(g * inv), -qmax, qmax).astype(np.int8).reshape(w.shape)
    if bits == 4:
        q = _pack_int4(q)
    sc = scales.squeeze(-2)
    if transposed:
        q = np.ascontiguousarray(np.swapaxes(q, -1, -2))
        if group_size != in_features:
            sc = np.ascontiguousarray(np.swapaxes(sc, -1, -2))
    dev = resolve_device(device)
    return QuantizedTensor(
        q=torch.from_numpy(np.ascontiguousarray(q)).to(dev),
        scales=torch.from_numpy(np.ascontiguousarray(sc, np.float32)).to(
            device=dev, dtype=scales_dtype),
        bits=bits, group_size=group_size, transposed=transposed,
        act_bits=act_bits)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense ``[(L,) in, out]`` weight (f32 products, one rounding)."""
    qt = standard_packing(qt)
    return dequant_weight(qt.q, qt.scales, bits=qt.bits, group_size=qt.group_size,
                          transposed=qt.transposed, dtype=torch.float32
                          ).to(dtype).contiguous()


def with_orientation(qt: QuantizedTensor, transposed: bool) -> QuantizedTensor:
    """The same weight in the other storage orientation (no numeric change;
    per-channel scales ``[.., 1, out]`` stay as they are). The bytes are
    copied into the new layout."""
    if qt.transposed == transposed:
        return qt
    per_channel = qt.group_size == qt.in_features
    return replace(qt, q=qt.q.transpose(-1, -2).contiguous(),
                   scales=qt.scales if per_channel
                   else qt.scales.transpose(-1, -2).contiguous(),
                   transposed=transposed)


def auto_orient(qt: QuantizedTensor) -> QuantizedTensor:
    """The reference's storage rule: act8 leaves and wide-output leaves
    (out > in) are stored transposed."""
    return with_orientation(qt, qt.act_bits == 8 or qt.out_features > qt.in_features)


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [M, K] · w [N, K]ᵀ`` for int8 operands. On the card
    ``torch._int_mm`` (it needs M > 16: shorter inputs are zero-padded)."""
    if a.device.type != "cuda":
        return int_dot(a, w)
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a, w.t())[:m]


def _matmul_a8(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """W8A8 / W4A8: per-token int8 activations, s8×s8→s32, one post-scale.

    Float combination as the reference: ``acc_lo + acc_hi * 0.0625`` for
    int4, where acc_hi = Σ x_hi · (16·hi)."""
    dtype = x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n_out = qt.out_features
    xq, sx = act_quantize(x2)
    s_col = qt.scales.reshape(n_out).float()
    p = qt.q if qt.transposed else qt.q.t()  # [out, k]
    if qt.bits == 8:
        acc = _int_mm(xq, p).float()
    else:
        half = qt.in_features // 2
        acc_lo = _int_mm(xq[:, :half].contiguous(), (p & 15) - 8)
        acc_hi = _int_mm(xq[:, half:].contiguous(), p & -16)
        acc = acc_lo.float() + acc_hi.float() * 0.0625
    return (acc * sx * s_col).to(dtype).reshape(*lead, n_out)


def _a8_int_acc(xq: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The exact int32 products ``xq [M, in] · q`` of an act8 per-channel
    leaf (int4: the low and high nibble products, the high one's factor 16
    taken out exactly)."""
    p = qt.q if qt.transposed else qt.q.t()  # [out, k]
    if qt.bits == 8:
        return _int_mm(xq, p)
    half = qt.in_features // 2
    acc_lo = _int_mm(xq[:, :half].contiguous(), (p & 15) - 8)
    acc_hi = _int_mm(xq[:, half:].contiguous(), p & -16)
    return acc_lo + (acc_hi >> 4)


def _weight_only_f32(x: torch.Tensor, w: QuantizedTensor, kernels: bool = True) -> torch.Tensor:
    """``x [..., in]`` through a 2-D weight-only leaf, the f32 sums not
    rounded to x's dtype: row 11's f32 mode where `linear` takes the kernel
    (at most 32 rows; never with ``kernels=False``), else the weight in x's
    dtype (`quant_matmul`'s) and an f32 product."""
    w = standard_packing(w)
    rows = x.numel() // x.shape[-1]
    if kernels and dequant_kernel_supported(rows, w.in_features, w.group_size):
        y = dequant_matmul(x.reshape(rows, x.shape[-1]).contiguous(), w.q, w.scales,
                           bits=w.bits, group_size=w.group_size, transposed=w.transposed,
                           out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.out_features)
    wt = dequant_weight(w.q, w.scales, bits=w.bits, group_size=w.group_size,
                        transposed=w.transposed, dtype=x.dtype)
    return x.float() @ wt.float()


def linear_row_parallel(x: torch.Tensor, w, mesh, kernels: bool = True) -> torch.Tensor:
    """``x [..., in/tp]`` through this rank's rows of a row-parallel leaf,
    summed over ``mesh`` (`parallel.mesh.Mesh`): the single device's
    `linear` of the whole row. On the differentiable route (``kernels``
    False, ``mesh`` a `parallel.mesh.DifferentiableMesh`) the sums are
    autograd's: the gradient of the summed output passes to every rank's
    part, and the act8 absmax's to the rank that holds it.

    * An act8 per-channel leaf quantizes its slice on the whole row's absmax
      (one ``all_reduce`` max), so its codes are the single device's, and
      sums the exact int32 products (one ``all_reduce`` sum) before the
      scales apply; while every partial sum stays below 2**24, the f32
      result is the single device's bit for bit.
    * A weight-only leaf (group-wise or per-channel, its groups whole on
      the rank) and a dense leaf sum f32 partial products (row 11's f32 mode
      at up to 32 rows), then round once to x's dtype, as the single
      device's sum is rounded once.
    * A `LoraLinear` runs its base so, then adds the adaptor: ``x·a`` of the
      rank's rows of ``a`` summed over tp in f32 and rounded once, then
      `add_adaptor`'s product with ``b`` and its scale.

    A stack of leaves (MoE experts: ``w`` ``[E, in/tp, out]`` or quantized
    ``q [E, ...]``) takes ``x [E, T, in/tp]``, entry by entry, with the same
    collectives for the whole stack."""
    lead = x.shape[:-1]
    if isinstance(w, LoraLinear):
        return add_adaptor(x, linear_row_parallel(x, w.base, mesh, kernels), w.a, w.b,
                           w.scale, mesh=mesh)
    if isinstance(w, QuantizedTensor) and w.act_bits is not None:
        if not (w.act_bits == 8 and w.group_size == w.in_features and w.q.ndim in (2, 3)):
            raise ValueError("a row-parallel act8 leaf must be per-channel")
        w = standard_packing(w)
        if w.q.ndim == 2:
            x = x.reshape(-1, x.shape[-1])
        absmax = mesh.all_reduce(x.float().abs().amax(dim=-1, keepdim=True), "max")
        xq, sx = act_quantize(x, absmax)
        if w.q.ndim == 2:
            acc = _a8_int_acc(xq, w)
        else:
            acc = torch.stack([_a8_int_acc(xq[e], w.layer(e)) for e in range(w.q.shape[0])])
        acc = mesh.all_reduce(acc).float()
        s_col = w.scales.reshape(*w.q.shape[:-2], 1, w.out_features).float()
        return (acc * sx * s_col).to(x.dtype).reshape(*lead, w.out_features)
    if isinstance(w, QuantizedTensor):
        part = _weight_only_f32(x, w, kernels) if w.q.ndim == 2 else torch.stack(
            [_weight_only_f32(x[e], w.layer(e), kernels) for e in range(w.q.shape[0])])
    else:
        part = x.float() @ w.float()
    return mesh.all_reduce(part).to(x.dtype)


def requantize_per_channel(qt: QuantizedTensor, bits: int = 8,
                           scales_dtype=torch.float32,
                           act_bits: Optional[int] = 8) -> QuantizedTensor:
    """Re-quantize a group-wise leaf onto per-channel scales (the layout the
    act8 scheme needs): the group-exact f32 values re-rounded, in the
    orientation `auto_orient` picks."""
    w = dequantize(qt, torch.float32)
    return auto_orient(quantize(w, bits=bits, group_size=None, scales_dtype=scales_dtype,
                                transposed=qt.transposed, act_bits=act_bits,
                                device=qt.q.device))


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x [..., in] @ dequant(qt) [in, out]``, the plain formulation.

    act8 per-channel leaves: `_matmul_a8`. Weight-only leaves: the weight in
    x's dtype (``q.to(T) * scales.to(T)``, int4 nibbles unpacked) and one
    matrix product in x's dtype, the JAX package's ``quant_matmul`` and
    ``_quant_matmul_transposed``."""
    if qt.act_bits == 8 and qt.group_size == qt.in_features and qt.q.ndim == 2:
        return _matmul_a8(x, qt)
    if qt.act_bits is not None:
        raise ValueError("act_bits=8 needs a 2-D per-channel leaf")
    w = dequant_weight(qt.q, qt.scales, bits=qt.bits, group_size=qt.group_size,
                       transposed=qt.transposed, dtype=x.dtype)
    return torch.matmul(x, w)


def add_adaptor(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                scale: float, mesh=None) -> torch.Tensor:
    """``y + (x·a)·b · scale``, the JAX package's LoRA epilogue: each product
    in the promoted dtype of its operands (rounded there), the scale rounded
    to y's dtype first, then one product and one sum in the result dtype.
    With ``mesh`` (a row-parallel leaf: ``x`` and ``a`` are this rank's
    rows) ``x·a`` is summed over tp in f32, then rounded once."""
    t = torch.promote_types(x.dtype, a.dtype)
    if mesh is None:
        adapt = x.to(t) @ a.to(t)
    else:
        adapt = mesh.all_reduce(x.float() @ a.float()).to(t)
    t = torch.promote_types(adapt.dtype, b.dtype)
    adapt = adapt.to(t) @ b.to(t)
    return y + adapt * torch.tensor(scale, dtype=y.dtype).item()


def linear(x: torch.Tensor, w, *, kernels: bool = True, tp=None) -> torch.Tensor:
    """Linear dispatch on the leaf type: dense ``[in, out]``, quantized, or
    `LoraLinear` (its base through this dispatch, then `add_adaptor`).
    ``tp`` (a `parallel.mesh.Mesh`) marks ``w`` as this rank's columns of a
    column-parallel leaf: a LoRA leaf's whole ``a`` then enters through
    ``tp.sum_grad`` (each rank's ``b`` columns see part of its gradient).

    A weight-only 2-D leaf with at most 32 rows of x (leading dims
    flattened) goes to the dequant-matmul kernel, as the JAX package's
    `_maybe_pallas` routes it; more rows take `quant_matmul`. With
    ``kernels=False`` every quantized leaf takes `quant_matmul`, plain
    PyTorch that autograd differentiates (the JAX package's training route:
    its `_maybe_pallas` is off there)."""
    if isinstance(w, LoraLinear):
        a = w.a if tp is None else tp.sum_grad(w.a)
        return add_adaptor(x, linear(x, w.base, kernels=kernels), a, w.b, w.scale)
    if not isinstance(w, QuantizedTensor):
        return x @ w
    w = standard_packing(w)
    rows = x.numel() // x.shape[-1]
    if kernels and w.act_bits is None and w.q.ndim == 2 \
            and dequant_kernel_supported(rows, w.in_features, w.group_size):
        y = dequant_matmul(x.reshape(rows, x.shape[-1]).contiguous(), w.q, w.scales,
                           bits=w.bits, group_size=w.group_size, transposed=w.transposed)
        return y.reshape(*x.shape[:-1], w.out_features)
    return quant_matmul(x, w)


def lookup_embedding(tokens: torch.Tensor, embed) -> torch.Tensor:
    """Embedding lookup at ``tokens``: a dense table ``[V, H]``, or a
    row-quantized one (``q [V, H(/2)]``, scales ``[V, H/g]``) whose gathered
    rows are unpacked (int4: half-split along H) and dequantized in f32. A
    dense table goes through ``F.embedding``, whose backward sums rows in a
    fixed order (indexing's accumulates in any order, so two runs of a train
    step could differ)."""
    if not isinstance(embed, QuantizedTensor):
        return torch.nn.functional.embedding(tokens, embed)
    q = embed.q[tokens]
    if embed.bits == 4:
        q = torch.cat([(q & 15) - 8, q >> 4], dim=-1)
    s = embed.scales[tokens]
    grouped = q.reshape(*q.shape[:-1], s.shape[-1], -1).float()
    return (grouped * s[..., None].float()).reshape(q.shape)


def init_random_quantized_params(config, *, bits: int = 4,
                                 group_size: Optional[int] = 32, seed: int = 0,
                                 scales_dtype=torch.bfloat16,
                                 max_seq_len: Optional[int] = None,
                                 act_bits: Optional[int] = None,
                                 dtype=torch.bfloat16, device=None):
    """Random quantized parameter tree made directly on the device: random
    packed bytes and small positive scales have the layout and cost of a real
    quantized checkpoint. Same layouts and scale dtype as the JAX package;
    the numbers come from a ``torch.Generator`` seeded with ``seed``."""
    from metalchat_tpu_torch.models.transformer import make_rope_tables

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, f = config.hidden_size, config.intermediate_size
    nh, nkv, hd, L = (config.num_heads, config.num_kv_heads, config.head_dim,
                      config.num_layers)
    pack = 2 if bits == 4 else 1

    def rand_q(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rand_s(shape):
        return (torch.rand(shape, generator=gen, device=dev) * 0.01
                + 0.001).to(scales_dtype)

    def qlin(in_f, out_f, stack=True):
        lead = (L,) if stack else ()
        g = in_f if group_size is None else group_size
        transposed = act_bits == 8 or out_f > in_f
        if transposed:
            q = rand_q(lead + (out_f, in_f // pack))
            s = rand_s(lead + ((1, out_f) if g == in_f else (out_f, in_f // g)))
        else:
            q = rand_q(lead + (in_f // pack, out_f))
            s = rand_s(lead + (in_f // g, out_f))
        return QuantizedTensor(q=q, scales=s, bits=bits, group_size=g,
                               transposed=transposed, act_bits=act_bits)

    layers = {
        "attn_norm": torch.ones((L, h), dtype=dtype, device=dev),
        "ffn_norm": torch.ones((L, h), dtype=dtype, device=dev),
        "wq": qlin(h, nh * hd),
        "wk": qlin(h, nkv * hd),
        "wv": qlin(h, nkv * hd),
        "wo": qlin(nh * hd, h),
        "w1": qlin(h, f),
        "w3": qlin(h, f),
        "w2": qlin(f, h),
    }
    if config.use_qk_norm:
        layers["q_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
        layers["k_norm"] = torch.ones((L, hd), dtype=dtype, device=dev)
    if config.use_post_norms:
        layers["post_attn_norm"] = torch.ones((L, h), dtype=dtype, device=dev)
        layers["post_ffn_norm"] = torch.ones((L, h), dtype=dtype, device=dev)
    embed = (torch.randn((config.vocab_size, h), generator=gen, device=dev)
             * 0.02).to(dtype)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dtype, device=dev),
        "lm_head": qlin(h, config.vocab_size, stack=False),
        "rope": make_rope_tables(config, max_seq_len, device=dev),
    }


_DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_params(params: Dict[str, Any], *, bits: int = 8,
                    group_size: Optional[int] = 32, targets=_DEFAULT_TARGETS,
                    quantize_lm_head: bool = False, quantize_embed: bool = False,
                    scales_dtype=torch.float32, act_bits: Optional[int] = None,
                    clip_search: bool = False) -> Dict[str, Any]:
    """Quantize selected dense ``[(L,) in, out]`` leaves of a parameter tree.

    Storage orientation as the reference's ``auto_orient``: act8 tensors and
    wide-output tensors are stored transposed. ``quantize_embed`` row-
    quantizes the embedding as the JAX package does: its transpose is
    quantized groupwise along H (no clip search, no act8) and stored
    row-major again."""
    def q(w):
        in_f, out_f = w.shape[-2:]
        return quantize(w, bits=bits, group_size=group_size,
                        scales_dtype=scales_dtype, act_bits=act_bits,
                        transposed=act_bits == 8 or out_f > in_f,
                        clip_search=clip_search, device=w.device)

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in targets:
        if name in out["layers"]:
            out["layers"][name] = q(out["layers"][name])
    if quantize_lm_head:
        out["lm_head"] = q(params["lm_head"])
    if quantize_embed:
        embed = params["embed"]
        qt = quantize(embed.T, bits=bits, group_size=group_size, scales_dtype=scales_dtype,
                      device=embed.device)
        out["embed"] = QuantizedTensor(q=qt.q.transpose(-1, -2).contiguous(),
                                       scales=qt.scales.transpose(-1, -2).contiguous(),
                                       bits=bits, group_size=qt.group_size)
    return out
