"""Causal prefill attention: CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Replaces ``metalchat_tpu/ops/flash_attention_pallas.py`` ``flash_attention``:
S new queries from ``start_pos`` (int or int32 ``[B]``) over the head-major
cache ``[B, n_kv, T, hd]``, causal, optional sliding window, f32 softmax
statistics. On the H100 the bf16 kernel runs both products on the tensor
cores (``wgmma``, P split into two bf16 parts), the f32 kernel on CUDA
cores; see the CUDA source.

q ``[B, S, nh, hd]`` → out ``[B, S, nh, hd]`` in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from metalchat_tpu_torch.ops import _build
from metalchat_tpu_torch.ops._build import HEAD_DIMS
from metalchat_tpu_torch.ops.reference import MASK_VALUE

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention.argtypes = [_P] * 4 + [_I, _P] + [_I] * 6 + [_F, _I, _I, _P]
    lib.flash_attention.restype = _I
    return lib


def _starts(start_pos, b: int, device) -> torch.Tensor:
    if torch.is_tensor(start_pos):
        return start_pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(start_pos), dtype=torch.int32, device=device)


def flash_attention_plain(q, k, v, start_pos, *, scale: float,
                          window: Optional[int] = None):
    b, s, nh, hd = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    groups = nh // nkv
    q_pos = _starts(start_pos, b, q.device).long()[:, None] + torch.arange(
        s, device=q.device)[None, :]
    kv_pos = torch.arange(t_max, device=q.device)[None, None, :]
    ok = kv_pos <= q_pos[:, :, None]                       # [B, S, T]
    if window is not None and window >= 0:
        ok &= kv_pos > q_pos[:, :, None] - window
    qg = q.float().reshape(b, s, nkv, groups, hd)
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) * scale
    scores = torch.where(ok[:, None, None], scores, MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    o = o * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd).to(q.dtype)


def flash_attention(q, k, v, start_pos, *, scale: float,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of S queries from ``start_pos`` over the cache."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, start_pos, scale=scale, window=window)
    _build.require_cuda("flash_attention", q, k, v)
    b, s, nh, hd = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    if k.shape != (b, nkv, t_max, hd) or v.shape != k.shape or nh % nkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v bf16 or f32, same dtype")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd in {HEAD_DIMS}, got {hd}")
    # An int start goes to the kernel as a scalar: no tensor, no extra launch.
    starts = _starts(start_pos, b, q.device) if torch.is_tensor(start_pos) else None
    out = torch.empty_like(q)
    rc = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if starts is None else starts.data_ptr(),
        0 if starts is not None else int(start_pos), out.data_ptr(),
        b, s, nh, nkv, t_max, hd, float(scale),
        -1 if window is None else int(window), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    _build.count_launch("flash_attention")
    return out
