"""Stacked W4A8/W8A8 decode matvec: CUDA kernel ``csrc/a8_matvec.cu`` and
its plain PyTorch version.

Replaces ``metalchat_tpu/ops/a8_matvec_pallas.py``
(``quant_matvec_stacked_fused`` and ``quant_matvec_stacked``). On the H100
the kernel is bound by the HBM stream of the packed weights (out·in/2 bytes
for int4); see the note at the top of the CUDA source for its design. At
every row count (1-16) a fused call is two launches from one C call: the
act-quant of `quantize_rows` (counter ``a8_quantize``, once per call) and
the int8 tensor-core matvec (counted as ``a8_matvec``, one per call); raw
mode is the matvec alone (counter ``a8_matvec_raw``).

Layouts as in the JAX package: weights ``[L, out, in/2]`` (int4, half-split
with an offset-binary low nibble) or ``[L, out, in]`` (int8); per-channel
scales ``[L, 1, out]`` in f32 or bf16; norm weights ``[L, in]``. ``layer``
is a Python int, or for the fused call a 0-d int32 tensor on x's device
(the JAX kernel's traced layer scalar): the kernel then reads the entry on
the card, so a routed expert (``l·E + topk``) needs no host read; that
instance counts as ``a8_matvec_indexed`` and takes no norm prologue. CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from metalchat_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
MAX_ROWS = 16


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("a8_matvec")
    lib.a8_quantize.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P]
    lib.a8_quantize.restype = _I
    lib.a8_mma_raw.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.a8_mma_raw.restype = _I
    lib.a8_quantize_mma.argtypes = [_P] * 6 + [_I] * 6 + [_F, _F, _P]
    lib.a8_quantize_mma.restype = _I
    lib.a8_quantize_mma_indexed.argtypes = [_P] * 6 + [_I] * 6 + [_L, _L, _P]
    lib.a8_quantize_mma_indexed.restype = _I
    return lib


# -- plain version ------------------------------------------------------------

def act_quantize(x: torch.Tensor, absmax: Optional[torch.Tensor] = None):
    """Per-token dynamic symmetric int8: x ≈ xq * sx, sx ``[..., 1]`` f32.

    Same ops and order as the reference ``_act_quantize``: absmax, ``sx = 1``
    where it is 0, then true divisions and round-half-to-even. (The divisor
    127 is a tensor on x's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently.) A given
    ``absmax`` ``[..., 1]`` f32 replaces x's own (a tensor-parallel slice of
    a row quantized on the whole row's absmax)."""
    xf = x.float()
    if absmax is None:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(absmax == 0.0, torch.ones_like(absmax),
                     absmax / absmax.new_full((), 127.0))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a [M, K] · b [N, K]ᵀ`` of int8 operands (plain:
    ``torch._int_mm`` on the CPU, an int32-accumulating product of its own,
    about 11 times faster there than an int32 ``@`` at Mixtral's widths;
    float64 on a GPU, where every partial sum of int8 products is exact)."""
    if a.device.type == "cpu":
        return torch._int_mm(a, b.T)
    out = torch.empty(a.shape[0], b.shape[0], dtype=torch.int32, device=a.device)
    ad = a.double()
    for i in range(0, b.shape[0], 8192):
        out[:, i:i + 8192] = (ad @ b[i:i + 8192].double().T).to(torch.int32)
    return out


def int_acc(xq: torch.Tensor, p: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer accumulator of int8 rows xq ``[B, in]`` against one layer of
    packed weights ``[out, k]`` (the nibble identities of ``_int_acc_w4``)."""
    if bits == 8:
        return int_dot(xq, p)
    half = xq.shape[1] // 2
    acc_lo = int_dot(xq[:, :half], p & 15)
    acc_hi = int_dot(xq[:, half:], p & -16)
    corr = 8 * xq[:, :half].sum(dim=1, keepdim=True, dtype=torch.int32)
    return (acc_lo - corr) + (acc_hi >> 4)


def quant_matvec_stacked_plain(xq, p_stack, layer: int, *, bits: int):
    return int_acc(xq, p_stack[layer], bits)


def prologue(x, norm_w=None, norm_eps=None, norm_offset: float = 0.0):
    """The fused kernel's prologue: optional rmsnorm (f32 statistics, scale
    ``offset + w``, rounded to x's dtype), then `act_quantize`."""
    xf = x.float()
    if norm_w is not None:
        var = xf.square().mean(dim=1, keepdim=True)
        normed = xf * torch.rsqrt(var + norm_eps)
        xf = (normed * (norm_offset + norm_w.float().reshape(1, -1))).to(x.dtype).float()
    return act_quantize(xf)


def quantize_rows_plain(x, norm_w=None, norm_eps=None, norm_offset: float = 0.0, *,
                        corr: bool = True):
    xq, sx = prologue(x, norm_w, norm_eps, norm_offset)
    c = (8 * xq[:, :xq.shape[1] // 2].sum(dim=1, dtype=torch.int32)) if corr else None
    return xq, sx.reshape(-1), c


def quant_matvec_stacked_fused_plain(x, p_stack, s_stack, layer, *, bits: int,
                                     norm_stack=None, norm_eps=None,
                                     norm_offset: float = 0.0):
    """``layer``: an int or a 0-d integer tensor (it indexes the stacks)."""
    norm_w = None if norm_stack is None else norm_stack[layer]
    xq, sx = prologue(x, norm_w, norm_eps, norm_offset)
    acc = int_acc(xq, p_stack[layer], bits)
    s_col = s_stack[layer].reshape(1, -1).float()
    return (acc.float() * sx * s_col).to(x.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check_shapes(x, p_stack, layer, bits: int) -> None:
    L, out_f, k = p_stack.shape
    b, in_f = x.shape
    if p_stack.dtype != torch.int8 or bits not in (4, 8):
        raise ValueError(f"a8_matvec: int8 weights and bits in (4, 8), got "
                         f"{p_stack.dtype}, {bits}")
    if k * (2 if bits == 4 else 1) != in_f:
        raise ValueError(f"a8_matvec: x {tuple(x.shape)} vs weights "
                         f"{tuple(p_stack.shape)} at bits={bits}")
    if not torch.is_tensor(layer) and not 0 <= layer < L:
        raise IndexError(f"a8_matvec: layer {layer} of {L}")
    if not 1 <= b <= MAX_ROWS or in_f % 32:
        raise ValueError(f"a8_matvec kernel: 1 <= rows <= {MAX_ROWS} and "
                         f"in % 32 == 0, got {tuple(x.shape)}")


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The kernels read their inputs in 16-byte loads and bulk copies."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("a8_matvec: operands must start 16-byte aligned")


def quant_matvec_stacked(xq: torch.Tensor, p_stack: torch.Tensor, layer: int, *,
                         bits: int) -> torch.Tensor:
    """Raw int32 ``[B, out]`` accumulator of pre-quantized int8 rows against
    layer ``layer`` of a stacked weight (bit-exact test surface)."""
    if xq.device.type == "cpu":
        return quant_matvec_stacked_plain(xq, p_stack, layer, bits=bits)
    _build.require_cuda("a8_matvec", xq, p_stack)
    _check_shapes(xq, p_stack, layer, bits)
    if xq.dtype != torch.int8:
        raise ValueError(f"a8_matvec raw mode takes int8 rows, got {xq.dtype}")
    b, in_f = xq.shape
    out_f = p_stack.shape[1]
    out = torch.empty(b, out_f, dtype=torch.int32, device=xq.device)
    _check_aligned(xq, p_stack[layer])
    rc = _lib().a8_mma_raw(xq.data_ptr(), p_stack[layer].data_ptr(), out.data_ptr(), b, in_f,
                           out_f, bits, _build.stream_ptr(xq))
    _build.check(rc, "a8_matvec_raw")
    _build.count_launch("a8_matvec_raw")
    return out


def quantize_rows(x: torch.Tensor, norm_w: Optional[torch.Tensor] = None,
                  norm_eps: Optional[float] = None, norm_offset: float = 0.0, *,
                  corr: bool = True):
    """The fused matvec's prologue for B rows, once: ``xq [B, in]`` int8,
    ``sx [B]`` f32 and, with ``corr``, the int4 correction ``8·Σ xq[:, :in/2]``
    as ``[B]`` int32 (else None). ``norm_w [in]`` in x's dtype adds the
    rmsnorm. One block a row on the card (kernel ``a8_quantize``)."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, norm_w, norm_eps, norm_offset, corr=corr)
    tensors = [x] + ([norm_w] if norm_w is not None else [])
    _build.require_cuda("a8_quantize", *tensors)
    b, in_f = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"a8_quantize: activations bf16 or f32, got {x.dtype}")
    if not 1 <= b <= MAX_ROWS or in_f % 32:
        raise ValueError(f"a8_quantize: 1 <= rows <= {MAX_ROWS} and in % 32 == 0, "
                         f"got {tuple(x.shape)}")
    if norm_w is not None:
        if norm_w.shape != (in_f,) or norm_w.dtype != x.dtype:
            raise ValueError(f"a8_quantize: norm weights [in] in x's dtype, got "
                             f"{tuple(norm_w.shape)} {norm_w.dtype}")
        if norm_eps is None:
            raise ValueError("a8_quantize: norm_eps is required with norm weights")
    _check_aligned(x, *([] if norm_w is None else [norm_w]))
    # One allocation, laid out as the fused matvec's workspace: the codes
    # [B, in], then sx [B] f32 and corr [B] int32 (in % 32 == 0 keeps them
    # aligned).
    n = b * in_f
    buf = torch.empty(n + 8 * b, dtype=torch.int8, device=x.device)
    xq = buf[:n].view(b, in_f)
    sx = buf[n:n + 4 * b].view(torch.float32)
    c = buf[n + 4 * b:].view(torch.int32) if corr else None
    rc = _lib().a8_quantize(
        x.data_ptr(), None if norm_w is None else norm_w.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), None if c is None else c.data_ptr(), b, in_f,
        int(x.dtype == torch.bfloat16), float(norm_eps or 0.0), float(norm_offset),
        _build.stream_ptr(x))
    _build.check(rc, "a8_quantize")
    _build.count_launch("a8_quantize")
    return xq, sx, c


def quant_matvec_stacked_fused(x: torch.Tensor, p_stack: torch.Tensor,
                               s_stack: torch.Tensor, layer, *, bits: int,
                               norm_stack: Optional[torch.Tensor] = None,
                               norm_eps: Optional[float] = None,
                               norm_offset: float = 0.0) -> torch.Tensor:
    """bf16/f32 rows ``[B, in]`` → ``[B, out]`` in x's dtype: optional rmsnorm
    prologue (``norm_stack [L, in]``), per-token int8 act-quant, s8×s8→s32
    against layer ``layer``, then ``acc·sx·s_col``. ``layer`` is an int, or
    a 0-d int32 tensor on x's device that the kernel reads (no norm then)."""
    if x.device.type == "cpu":
        return quant_matvec_stacked_fused_plain(
            x, p_stack, s_stack, layer, bits=bits, norm_stack=norm_stack,
            norm_eps=norm_eps, norm_offset=norm_offset)
    tensors = [x, p_stack, s_stack] + ([norm_stack] if norm_stack is not None else [])
    _build.require_cuda("a8_matvec", *tensors)
    _check_shapes(x, p_stack, layer, bits)
    L, out_f, _ = p_stack.shape
    b, in_f = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"a8_matvec: activations bf16 or f32, got {x.dtype}")
    if s_stack.shape != (L, 1, out_f) or s_stack.dtype not in (torch.bfloat16,
                                                               torch.float32):
        raise ValueError(f"a8_matvec: scales [L, 1, out] f32/bf16, got "
                         f"{tuple(s_stack.shape)} {s_stack.dtype}")
    if torch.is_tensor(layer):
        if norm_stack is not None:
            raise ValueError("a8_matvec: a device index takes no norm prologue")
        return _indexed(x, p_stack, s_stack, layer, bits)
    norm_w = None
    if norm_stack is not None:
        if norm_stack.shape != (L, in_f) or norm_stack.dtype != x.dtype:
            raise ValueError(f"a8_matvec: norm weights [L, in] in x's dtype, got "
                             f"{tuple(norm_stack.shape)} {norm_stack.dtype}")
        if norm_eps is None:
            raise ValueError("a8_matvec: norm_eps is required with norm_stack")
        norm_w = norm_stack[layer]
    out = torch.empty(b, out_f, dtype=x.dtype, device=x.device)
    # quantize_rows' codes, sx and corr in one workspace, held until the
    # launch; one C call launches a8_quantize and then the matvec (batch-1
    # decode is host-bound: its wrapper's host time is the step's).
    ws = torch.empty(b * in_f + 8 * b, dtype=torch.int8, device=x.device)
    p, s = p_stack[layer], s_stack[layer]
    _check_aligned(x, p, *([] if norm_w is None else [norm_w]))
    rc = _lib().a8_quantize_mma(
        x.data_ptr(), None if norm_w is None else norm_w.data_ptr(), p.data_ptr(), s.data_ptr(),
        ws.data_ptr(), out.data_ptr(), b, in_f, out_f, bits, int(x.dtype == torch.bfloat16),
        int(s_stack.dtype == torch.bfloat16), float(norm_eps or 0.0), float(norm_offset),
        _build.stream_ptr(x))
    _build.check(rc, "a8_matvec_fused")
    _build.count_launch("a8_quantize")
    _build.count_launch("a8_matvec")
    return out


def _indexed(x, p_stack, s_stack, index: torch.Tensor, bits: int) -> torch.Tensor:
    """The fused call with the stack entry in a 0-d int32 tensor on x's
    card, read by the kernel (never on the host)."""
    if index.device != x.device:
        raise RuntimeError(f"a8_matvec: the index is on {index.device}, x on {x.device}; "
                           "a device index lies on x's card")
    if index.shape != () or index.dtype != torch.int32:
        raise ValueError(f"a8_matvec: the index is a 0-d int32 tensor, got "
                         f"{tuple(index.shape)} {index.dtype}")
    _, out_f, k = p_stack.shape
    b, in_f = x.shape
    out = torch.empty(b, out_f, dtype=x.dtype, device=x.device)
    ws = torch.empty(b * in_f + 8 * b, dtype=torch.int8, device=x.device)
    _check_aligned(x, p_stack)
    if (out_f * k) % 16:
        raise ValueError("a8_matvec: every stack entry must start 16-byte aligned")
    rc = _lib().a8_quantize_mma_indexed(
        x.data_ptr(), p_stack.data_ptr(), s_stack.data_ptr(), index.data_ptr(), ws.data_ptr(),
        out.data_ptr(), b, in_f, out_f, bits, int(x.dtype == torch.bfloat16),
        int(s_stack.dtype == torch.bfloat16), out_f * k, out_f, _build.stream_ptr(x))
    _build.check(rc, "a8_matvec_indexed")
    _build.count_launch("a8_quantize")
    _build.count_launch("a8_matvec_indexed")
    return out
