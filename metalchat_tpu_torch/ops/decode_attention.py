"""Decode attention over a dense stacked KV cache: CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch versions.

Replaces ``metalchat_tpu/ops/decode_attention_pallas.py``:

* ``decode_attention_update_quantized_stacked`` (write mode): quantize the
  new K/V row, write it and its scale into layer ``layer`` of the stacked
  int8 cache at ``pos = length - 1`` (IN PLACE), then single-token GQA
  attention over ``[window_lo, length)``;
* ``decode_attention_stacked`` / ``decode_attention_quantized_stacked``
  (read-only mode): the same attention over a cache the caller has already
  updated, in the activation dtype or int8; ``decode_attention`` /
  ``decode_attention_quantized`` are the same call on an unstacked layer.

On the H100 it is bound by the bytes of the K/V rows it reads and, at
batch 1, by latency. The kernel splits the positions over blocks of
``SPLIT_CHUNK`` positions each and merges their partials in the same
launch (flash-decoding); see the CUDA source for its design.

Layouts: q ``[B, nh, hd]`` (heads kv-major), new rows ``[B, n_kv, hd]``,
cache ``[L, B, n_kv, T, hd]`` (int8 with scales ``[L, B, n_kv, T]`` f32, or
q's dtype), lengths int32 ``[B]`` including the new token, each in ``[1,
T]``, window ``None`` or an int (``-1`` = global). The write mode returns
``(attn, k, v, k_scale, v_scale)``, the cache tensors being the ones passed
in; the read-only mode returns ``attn``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from metalchat_tpu_torch.cache import quantize_kv
from metalchat_tpu_torch.ops import _build
from metalchat_tpu_torch.ops._build import HEAD_DIMS
from metalchat_tpu_torch.ops.reference import MASK_VALUE

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Cache positions per block of the kernel (csrc/decode_attention.cu kChunk;
# the kernel refuses any other value).
SPLIT_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    lib.decode_attention_update.argtypes = [_P] * 11 + [_I] * 6 + [_F, _I, _I, _P]
    lib.decode_attention_update.restype = _I
    lib.decode_attention.argtypes = [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _P]
    lib.decode_attention.restype = _I
    return lib


def _merge_buffers(q: torch.Tensor, n_counters: int, t_max: int):
    """The arrival counters and the kernel's f32 partials, ``B * nh *
    ceil(t_max / SPLIT_CHUNK) * (hd + 2)`` values (acc, then m and l, of
    every query head and chunk). The caller holds both until the launch: a
    workspace freed before it could be handed to counters made in between."""
    b, nh, hd = q.shape
    counters = _build.arrival_counters(q.device, n_counters)
    n_split = -(-t_max // SPLIT_CHUNK)
    return counters, torch.empty(b * nh * n_split * (hd + 2), dtype=torch.float32,
                                 device=q.device)


def _window(window: Optional[int]) -> int:
    return -1 if window is None else int(window)


def attention_plain(q, k, v, k_scale, v_scale, lengths, *, scale: float,
                    window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA attention over a cache ``k, v [B, n_kv, T, hd]``
    (int8 with scales ``[B, n_kv, T]``, or unscaled with scales None),
    positions ``[window_lo, length)``: the k-scale on the scores, the
    v-scale on the probabilities, f32."""
    b, nh, hd = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, nkv, nh // nkv, hd)
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    t = torch.arange(t_max, device=q.device)[None, :]
    length = lengths.long()[:, None]
    ok = t < length
    w = _window(window)
    if w >= 0:
        ok &= t > length - 1 - w
    s = torch.where(ok[:, None, None, :], s, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    o = o * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return o.reshape(b, nh, hd).to(q.dtype)


def _check_lengths(lengths, t_max: int, what: str) -> None:
    if bool(((lengths < 1) | (lengths > t_max)).any()):
        raise ValueError(f"{what}: lengths must lie in [1, {t_max}]")


def decode_attention_update_plain(q, k_new, v_new, k, v, k_scale, v_scale,
                                  layer: int, lengths, *, scale: float,
                                  window: Optional[int] = None):
    b = q.shape[0]
    _check_lengths(lengths, k.shape[3], "decode_attention_update")
    rows = torch.arange(b, device=q.device)
    pos = lengths.long() - 1
    qk, sk = quantize_kv(k_new)
    qv, sv = quantize_kv(v_new)
    k[layer][rows, :, pos] = qk
    v[layer][rows, :, pos] = qv
    k_scale[layer][rows, :, pos] = sk
    v_scale[layer][rows, :, pos] = sv
    out = attention_plain(q, k[layer], v[layer], k_scale[layer], v_scale[layer], lengths,
                          scale=scale, window=window)
    return out, k, v, k_scale, v_scale


def decode_attention_stacked_plain(q, k, v, k_scale, v_scale, layer: int, lengths, *,
                                   scale: float, window: Optional[int] = None):
    """Read-only attention over layer ``layer``; scales None for a cache in
    the activation dtype."""
    _check_lengths(lengths, k.shape[3], "decode_attention")
    return attention_plain(q, k[layer], v[layer],
                           None if k_scale is None else k_scale[layer],
                           None if v_scale is None else v_scale[layer], lengths,
                           scale=scale, window=window)


def check_args(q, k_new, v_new, k, v, k_scale, v_scale, layer: int, lengths) -> None:
    """The kernel's preconditions on shapes and dtypes (it indexes every
    cache tensor with k's strides and writes into them in place). Lengths
    are data on the card and are not checked here: the kernel leaves the
    cache untouched and returns NaN for a row whose length is outside
    ``[1, t_max]``."""
    b, nh, hd = q.shape
    L, _, nkv, t_max, _ = k.shape
    if (k.dtype != torch.int8 or v.dtype != torch.int8
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("decode_attention_update: int8 cache with f32 scales")
    if q.dtype not in (torch.bfloat16, torch.float32) or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise ValueError("decode_attention_update: q/k_new/v_new bf16 or f32, same dtype")
    if (k_new.shape != (b, nkv, hd) or v_new.shape != k_new.shape
            or k.shape != (L, b, nkv, t_max, hd) or v.shape != k.shape
            or k_scale.shape != (L, b, nkv, t_max) or v_scale.shape != k_scale.shape
            or nh % nkv or lengths.shape != (b,) or lengths.dtype != torch.int32):
        raise ValueError("decode_attention_update: shape mismatch")
    if hd not in HEAD_DIMS or nh // nkv > 32 or not 0 <= layer < L:
        raise ValueError(f"decode_attention_update: hd in {HEAD_DIMS}, groups <= 32 and "
                         f"0 <= layer < {L}, got hd={hd}, groups={nh // nkv}, "
                         f"layer={layer}")


def decode_attention_update_quantized_stacked(q, k_new, v_new, k, v, k_scale, v_scale,
                                              layer: int, lengths, *, scale: float,
                                              window: Optional[int] = None):
    """Quantize + write the new row into layer ``layer`` in place, then attend.

    Returns ``(attn [B, nh, hd], k, v, k_scale, v_scale)``."""
    if q.device.type == "cpu":
        return decode_attention_update_plain(
            q, k_new, v_new, k, v, k_scale, v_scale, layer, lengths,
            scale=scale, window=window)
    _build.require_cuda("decode_attention_update", q, k_new, v_new, k, v,
                        k_scale, v_scale, lengths)
    check_args(q, k_new, v_new, k, v, k_scale, v_scale, layer, lengths)
    b, nh, hd = q.shape
    nkv, t_max = k.shape[2], k.shape[3]
    out = torch.empty_like(q)
    counters, ws = _merge_buffers(q, b * nkv, t_max)
    rc = _lib().decode_attention_update(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k[layer].data_ptr(),
        v[layer].data_ptr(), k_scale[layer].data_ptr(), v_scale[layer].data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, nh, nkv,
        t_max, hd, SPLIT_CHUNK, float(scale), _window(window), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q))
    _build.check(rc, "decode_attention_update")
    _build.count_launch("decode_attention_update")
    return out, k, v, k_scale, v_scale


def check_read_args(q, k, v, k_scale, v_scale, layer: int, lengths) -> None:
    """The read-only kernel's preconditions: an int8 cache with f32 scales,
    or a cache in q's dtype without scales, all indexed with k's strides."""
    b, nh, hd = q.shape
    L, _, nkv, t_max, _ = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("decode_attention: q bf16 or f32")
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype or v_scale is not None:
            raise ValueError("decode_attention: an unscaled cache has q's dtype")
    elif (k.dtype != torch.int8 or v.dtype != torch.int8 or v_scale is None
          or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
          or k_scale.shape != (L, b, nkv, t_max) or v_scale.shape != k_scale.shape):
        raise ValueError("decode_attention: int8 cache with f32 scales [L, B, n_kv, T]")
    if (k.shape != (L, b, nkv, t_max, hd) or v.shape != k.shape or nh % nkv
            or lengths.shape != (b,) or lengths.dtype != torch.int32):
        raise ValueError("decode_attention: shape mismatch")
    if hd not in HEAD_DIMS or nh // nkv > 32 or not 0 <= layer < L:
        raise ValueError(f"decode_attention: hd in {HEAD_DIMS}, groups <= 32 and "
                         f"0 <= layer < {L}, got hd={hd}, groups={nh // nkv}, "
                         f"layer={layer}")


def _read(q, k, v, k_scale, v_scale, layer: int, lengths, scale: float,
          window: Optional[int], counter: str = "decode_attention") -> torch.Tensor:
    """The read-only launch; ``counter`` names it in the launch counts (the
    one-layer forms, the JAX package's ``decode_attention(_quantized)``,
    count as ``decode_attention_layer``)."""
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k, v, k_scale, v_scale, layer, lengths,
                                              scale=scale, window=window)
    scales = () if k_scale is None else (k_scale, v_scale)
    _build.require_cuda("decode_attention", q, k, v, *scales, lengths)
    check_read_args(q, k, v, k_scale, v_scale, layer, lengths)
    b, nh, hd = q.shape
    nkv, t_max = k.shape[2], k.shape[3]
    out = torch.empty_like(q)
    counters, ws = _merge_buffers(q, b * nkv, t_max)
    rc = _lib().decode_attention(
        q.data_ptr(), k[layer].data_ptr(), v[layer].data_ptr(),
        None if k_scale is None else k_scale[layer].data_ptr(),
        None if v_scale is None else v_scale[layer].data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, nh, nkv,
        t_max, hd, SPLIT_CHUNK, float(scale), _window(window), int(q.dtype == torch.bfloat16),
        int(k_scale is not None), _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    _build.count_launch(counter)
    return out


def decode_attention_stacked(q, k, v, layer: int, lengths, *, scale: float,
                             window: Optional[int] = None) -> torch.Tensor:
    """Attention over layer ``layer`` of a stacked cache in q's dtype."""
    return _read(q, k, v, None, None, layer, lengths, scale, window)


def decode_attention_quantized_stacked(q, k, v, k_scale, v_scale, layer: int, lengths, *,
                                       scale: float,
                                       window: Optional[int] = None) -> torch.Tensor:
    """Attention over layer ``layer`` of a stacked int8 cache."""
    return _read(q, k, v, k_scale, v_scale, layer, lengths, scale, window)


def decode_attention(q, k, v, lengths, *, scale: float,
                     window: Optional[int] = None) -> torch.Tensor:
    """`decode_attention_stacked` on one layer ``k, v [B, n_kv, T, hd]``."""
    return _read(q, k[None], v[None], None, None, 0, lengths, scale, window,
                 "decode_attention_layer")


def decode_attention_quantized(q, k, v, k_scale, v_scale, lengths, *, scale: float,
                               window: Optional[int] = None) -> torch.Tensor:
    """`decode_attention_quantized_stacked` on one layer."""
    return _read(q, k[None], v[None], k_scale[None], v_scale[None], 0, lengths, scale,
                 window, "decode_attention_layer")
