"""Merged post-attention block for W4A8/W8A8 decode: CUDA kernel
``csrc/ffn_block.cu`` (one cooperative launch a layer) and its plain PyTorch
version.

Replaces ``metalchat_tpu/ops/ffn_block_pallas.py`` (``ffn_block_stacked``)::

    x2  = x + wo(attn)
    out = x2 + w2(act(gate(x2n)) · up(x2n)),  x2n = rmsnorm(x2) · (offset + w)

Each linear is the act8 matvec of ``ops/a8_matvec.py`` (per-token int8
act-quant, s8×s8→s32, ``acc·sx·s_col`` rounded to the activation dtype).
The activation runs in f32, as in the TPU kernel; the unmerged decode path
runs it in the activation dtype.

Layouts as ``ops/a8_matvec.py``: weights ``[L, out, in/2]`` (int4) or
``[L, out, in]`` (int8), per-channel scales ``[L, 1, out]``, norm weights
``[L, H]``; w13 holds the gate rows then the up rows. ``layer`` is a Python
int. CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from metalchat_tpu_torch.ops import _build, reference
from metalchat_tpu_torch.ops.a8_matvec import (MAX_ROWS, _check_aligned, act_quantize, int_acc,
                                               prologue)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ACTS = ("silu", "gelu_tanh")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("ffn_block")
    lib.ffn_block.argtypes = [_P] * 15 + [_I] * 7 + [_F, _F, _P]
    lib.ffn_block.restype = _I
    return lib


# -- plain version ------------------------------------------------------------

def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    """The gate activation on f32 values."""
    return reference.activation(act)(g)


def _linear(xq, sx, p, s, bits):
    """One matvec's f32 output ``acc·sx·s_col`` from int8 codes."""
    return int_acc(xq, p, bits).float() * sx * s.reshape(1, -1).float()


def wo_stage(attn, x, wo_q, wo_s, *, bits: int):
    """Phase A: ``x2 = x + wo(attn)`` (one layer's weights)."""
    xq, sx = act_quantize(attn)
    return x + _linear(xq, sx, wo_q, wo_s, bits).to(x.dtype)


def w13_stage(x2, norm_w, w13_q, w13_s, *, bits: int, act: str, eps: float,
              offset: float = 0.0):
    """Phase B: ``h = act(gate)·up`` of the normed x2, in x2's dtype. Also
    returns the f32 gate and up and the norm codes' scale ``sx``."""
    xq, sx = prologue(x2, norm_w, eps, offset)
    gate, up = _linear(xq, sx, w13_q, w13_s, bits).chunk(2, dim=-1)
    return (activation(gate, act) * up).to(x2.dtype), gate, up, sx


def w2_stage(h, x2, w2_q, w2_s, *, bits: int):
    """Phase C: ``out = x2 + w2(h)``. Also returns the codes' scale ``sx``."""
    xq, sx = act_quantize(h)
    return x2 + _linear(xq, sx, w2_q, w2_s, bits).to(x2.dtype), sx


def ffn_block_plain(attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s, layer: int, *,
                    bits: int, act: str, eps: float, offset: float = 0.0, scratch=None):
    """``_ffn_block_kernel``'s ops in its order, on layer ``layer``."""
    x2 = wo_stage(attn, x, wo_q[layer], wo_s[layer], bits=bits)
    h = w13_stage(x2, norm_w[layer], w13_q[layer], w13_s[layer], bits=bits, act=act,
                  eps=eps, offset=offset)[0]
    if scratch is not None:
        scratch.update(x2=x2, h=h, norm_codes=prologue(x2, norm_w[layer], eps, offset)[0])
    return w2_stage(h, x2, w2_q[layer], w2_s[layer], bits=bits)[0]


# -- kernel wrapper -----------------------------------------------------------

def supported(rows: int, hidden: int, inter: int) -> bool:
    """The shapes the kernel takes: 1-16 rows, widths multiples of 32."""
    return 1 <= rows <= MAX_ROWS and hidden % 32 == 0 and inter % 32 == 0


def ffn_block_stacked(attn: torch.Tensor, x: torch.Tensor, wo_q, wo_s, norm_w, w13_q, w13_s,
                      w2_q, w2_s, layer: int, *, bits: int, act: str, eps: float,
                      offset: float = 0.0, scratch: Optional[dict] = None) -> torch.Tensor:
    """The layer's residual stream after its FFN, ``[B, H]`` in x's dtype.

    ``scratch``, a dict, receives the intermediates ``x2`` ``[B, H]`` and
    ``h`` ``[B, F]`` (the kernel's own scratch buffers): the checks hold
    each phase on its own. At 2-16 rows it also receives ``norm_codes``
    ``[B, H]``, the int8 codes of the normed x2 that phase B multiplied
    (the codes workspace; at one row each block keeps its codes in shared
    memory)."""
    if act not in ACTS:
        raise ValueError(f"ffn_block: act in {ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return ffn_block_plain(attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s, layer,
                               bits=bits, act=act, eps=eps, offset=offset, scratch=scratch)
    _build.require_cuda("ffn_block", attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s)
    b, hidden = x.shape
    L = wo_q.shape[0]
    pack = 2 if bits == 4 else 1
    inter = w13_q.shape[1] // 2
    if bits not in (4, 8) or any(t.dtype != torch.int8 for t in (wo_q, w13_q, w2_q)):
        raise ValueError(f"ffn_block: int8 weights and bits in (4, 8), got {bits}")
    shapes = {"attn": (tuple(attn.shape), (b, hidden)),
              "wo": (tuple(wo_q.shape), (L, hidden, hidden // pack)),
              "w13": (tuple(w13_q.shape), (L, 2 * inter, hidden // pack)),
              "w2": (tuple(w2_q.shape), (L, hidden, inter // pack)),
              "wo scales": (tuple(wo_s.shape), (L, 1, hidden)),
              "w13 scales": (tuple(w13_s.shape), (L, 1, 2 * inter)),
              "w2 scales": (tuple(w2_s.shape), (L, 1, hidden)),
              "norm": (tuple(norm_w.shape), (L, hidden))}
    bad = {k: v for k, v in shapes.items() if v[0] != v[1]}
    if bad:
        raise ValueError(f"ffn_block: shapes (got, want) {bad}")
    if not supported(b, hidden, inter):
        raise ValueError(f"ffn_block kernel: 1 <= rows <= {MAX_ROWS}, H and F multiples "
                         f"of 32, got rows {b}, H {hidden}, F {inter}")
    if not 0 <= layer < L:
        raise IndexError(f"ffn_block: layer {layer} of {L}")
    if x.dtype not in (torch.bfloat16, torch.float32) or attn.dtype != x.dtype \
            or norm_w.dtype != x.dtype:
        raise ValueError(f"ffn_block: attn, x and norm weights in one dtype, bf16 or f32, "
                         f"got {attn.dtype}, {x.dtype}, {norm_w.dtype}")
    s_dtypes = {wo_s.dtype, w13_s.dtype, w2_s.dtype}
    if len(s_dtypes) != 1 or not s_dtypes <= {torch.bfloat16, torch.float32}:
        raise ValueError(f"ffn_block: scales all f32 or all bf16, got {s_dtypes}")
    _check_aligned(attn, norm_w[layer], wo_q[layer], w13_q[layer], w2_q[layer])
    x2 = torch.empty_like(x)
    h = torch.empty(b, inter, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    # At 2-16 rows block b quantizes row b for all: each phase's codes
    # [3][B][max(H, F)], then sx [3][B] f32 and corr [3][B] int32; held until
    # the launch. At one row every block quantizes the row itself.
    shared = b > 1
    n_codes = 3 * b * max(hidden, inter)
    ws = torch.empty(n_codes + 24 * b, dtype=torch.int8, device=x.device) if shared else None
    at = (lambda off: ws.data_ptr() + off) if shared else (lambda off: None)  # noqa: E731
    rc = _lib().ffn_block(
        attn.data_ptr(), x.data_ptr(), wo_q[layer].data_ptr(), wo_s[layer].data_ptr(),
        norm_w[layer].data_ptr(), w13_q[layer].data_ptr(), w13_s[layer].data_ptr(),
        w2_q[layer].data_ptr(), w2_s[layer].data_ptr(), x2.data_ptr(), h.data_ptr(),
        out.data_ptr(), at(0), at(n_codes), at(n_codes + 12 * b), b, hidden, inter, bits,
        ACTS.index(act), int(x.dtype == torch.bfloat16), int(wo_s.dtype == torch.bfloat16),
        float(eps), float(offset), _build.stream_ptr(x))
    _build.check(rc, "ffn_block")
    _build.count_launch("ffn_block")
    if scratch is not None:
        scratch.update(x2=x2, h=h)
        if shared:  # phase B's rows of the codes workspace
            m = max(hidden, inter)
            scratch["norm_codes"] = ws[b * m:b * m + b * hidden].view(b, hidden)
    return out
