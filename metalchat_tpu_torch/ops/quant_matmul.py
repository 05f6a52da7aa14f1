"""Weight-only group-quantized matmul for decode-sized row counts: CUDA
kernel ``csrc/quant_matmul.cu`` and its plain PyTorch version.

Replaces ``metalchat_tpu/ops/quant_matmul_pallas.py`` (``quant_matmul_pallas``:
``_int8_kernel`` and ``_int4_kernel``). On the H100 the kernel is bound by
the stream of packed weights and group scales; see the note at the top of
the CUDA source for its design.

What it computes (the TPU kernel's rounding and the JAX package's XLA
``quant_matmul``): each weight element is ``T(float(q) · float(T(s)))`` in
the activation dtype T, x is read as T, the products are summed in f32 and
the output is rounded to T. Layouts as in the JAX package, both storage
orientations:

* non-transposed: q ``[in, out]`` (int8) or ``[in/2, out]`` (int4),
  scales ``[in/g, out]``;
* transposed: q ``[out, in]`` or ``[out, in/2]``, scales ``[out, in/g]``;
* per-channel scales (``g == in``) are ``[1, out]`` in both orientations.

int4 is half-split with an offset-binary low nibble: packed row r holds
input r (low nibble, ``+8``) and input ``r + in/2`` (high nibble, two's
complement). CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from metalchat_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_ROWS = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("quant_matmul")
    lib.quant_matmul.argtypes = [_P] * 6 + [_I] * 11 + [_P]
    lib.quant_matmul.restype = _I
    return lib


# -- plain version ------------------------------------------------------------

def unpack_int4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Signed nibble values, the packed axis ``dim`` doubled (lo then hi)."""
    lo = (packed & 15) - 8
    hi = packed >> 4  # arithmetic: the high nibble is two's complement
    return torch.cat([lo, hi], dim=dim)


def dequant_weight(q: torch.Tensor, scales: torch.Tensor, *, bits: int, group_size: int,
                   transposed: bool, dtype) -> torch.Tensor:
    """The logical ``[(L,) in, out]`` weight in ``dtype`` as the JAX package's
    ``quant_matmul`` forms it: ``q.astype(T) * scales.astype(T)``, one
    rounding to T (a view of the transposed storage for ``transposed``)."""
    axis = -1 if transposed else -2  # the in axis of the storage
    w = unpack_int4(q, axis) if bits == 4 else q
    in_f = w.shape[axis]
    s = scales.to(dtype)
    if group_size == in_f:  # per-channel: [.., 1, out] in both orientations
        w = w.to(dtype) * (s.transpose(-1, -2) if transposed else s)
    elif transposed:  # [.., out, in] * [.., out, in/g]
        w = w.to(dtype) * s.repeat_interleave(group_size, dim=-1)
    else:  # [.., in, out] * [.., in/g, out]
        w = w.to(dtype) * s.repeat_interleave(group_size, dim=-2)
    return w.transpose(-1, -2) if transposed else w


def dequant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
                         bits: int, group_size: int, transposed: bool) -> torch.Tensor:
    """x ``[B, in]`` @ the weight in x's dtype, f32 sums, out in x's dtype."""
    w = dequant_weight(q, scales, bits=bits, group_size=group_size,
                       transposed=transposed, dtype=x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


# -- kernel wrapper -----------------------------------------------------------

# The non-transposed kernel's split over k (csrc/quant_matmul.cu qmm_natural):
# 8 warps a block, each thread ``cols`` output columns (a strip of 32·cols a
# warp), at least ``NAT_MIN_ROWS`` packed rows a block (so that the f32
# partials stay small beside the weights), x's slice staged in at most
# ``NAT_STAGE_BYTES`` of shared memory, about ``NAT_BLOCKS_PER_SM`` blocks an SM
# (both keyed by the kernel's row bound: 1, 8 or 32 rows).
NAT_WARPS = 8
NAT_BLOCKS_PER_SM = {1: 2, 8: 4, 32: 2}
NAT_MIN_ROWS = {1: 64, 8: 128, 32: 256}
NAT_STAGE_BYTES = 96 * 1024


@functools.lru_cache(maxsize=None)
def natural_plan(rows: int, k: int, out_f: int, sms: int):
    """``(cols, n_split, per_split)`` of the non-transposed kernel: columns a
    thread, blocks along the ``k`` packed rows and packed rows a block."""
    maxb = 1 if rows == 1 else 8 if rows <= 8 else 32
    cols = {1: 16, 8: 8, 32: 4}[maxb]
    strips = -(-out_f // (32 * cols))
    n_split = max(1, min(-(-NAT_BLOCKS_PER_SM[maxb] * sms // strips),
                         -(-k // NAT_MIN_ROWS[maxb])))
    per = -(-k // n_split)
    per = -(-per // 8) * 8
    per = min(per, max(8, NAT_STAGE_BYTES // (8 * rows) // 8 * 8))
    return cols, -(-k // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def supported(rows: int, in_f: int, group_size: int) -> bool:
    """The shapes the kernel takes: 1-32 rows, in-features a multiple of 32
    (16-byte loads of int4 rows) and groups a multiple of 16 (a 16-byte load
    never straddles two groups)."""
    return 1 <= rows <= MAX_ROWS and in_f % 32 == 0 and group_size % 16 == 0 \
        and in_f % group_size == 0


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *, bits: int,
                   group_size: int, transposed: bool) -> torch.Tensor:
    """bf16/f32 rows ``[B, in]`` (B ≤ 32) @ dequant(q, scales) → ``[B, out]``
    in x's dtype."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, q, scales, bits=bits, group_size=group_size,
                                    transposed=transposed)
    _build.require_cuda("quant_matmul", x, q, scales)
    b, in_f = x.shape
    pack = 2 if bits == 4 else 1
    if q.dtype != torch.int8 or bits not in (4, 8) or q.ndim != 2:
        raise ValueError(f"quant_matmul: 2-D int8 weights and bits in (4, 8), got "
                         f"{tuple(q.shape)} {q.dtype}, {bits}")
    out_f = q.shape[0] if transposed else q.shape[1]
    k = q.shape[1] if transposed else q.shape[0]
    if k * pack != in_f:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs weights {tuple(q.shape)} "
                         f"at bits={bits}, transposed={transposed}")
    if not supported(b, in_f, group_size):
        raise ValueError(f"quant_matmul kernel: 1 <= rows <= {MAX_ROWS}, in % 32 == 0 "
                         f"and group % 16 == 0, got x {tuple(x.shape)}, group {group_size}")
    n_groups = in_f // group_size
    if n_groups == 1:
        want = (1, out_f)
    else:
        want = (out_f, n_groups) if transposed else (n_groups, out_f)
    if tuple(scales.shape) != want or scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul: scales {want} f32/bf16, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul: activations bf16 or f32, got {x.dtype}")
    out = torch.empty(b, out_f, dtype=x.dtype, device=x.device)
    cols = n_split = per = 0
    ws = counters = None
    if not transposed:
        cols, n_split, per = natural_plan(b, k, out_f, _sm_count(x.device))
        if n_split > 1:
            ws = torch.empty(n_split * b * out_f, dtype=torch.float32, device=x.device)
            counters = _build.arrival_counters(x.device, -(-out_f // (32 * cols)))
    rc = _lib().quant_matmul(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), b, in_f, out_f, group_size, bits,
        int(transposed), int(x.dtype == torch.bfloat16), int(scales.dtype == torch.bfloat16),
        cols, n_split, per, _build.stream_ptr(x))
    _build.check(rc, "quant_matmul")
    _build.count_launch("quant_matmul")
    return out
