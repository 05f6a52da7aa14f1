"""KV caches (port of the JAX package's ``cache.py``, dense and int8).

Layouts match the JAX package: payload ``[L, B, n_kv, T, hd]`` head-major,
int8 scales flat ``[L, B, n_kv, T]`` in f32. Unlike the JAX package, whose
arrays are immutable, every update here writes the cache tensors IN PLACE
and returns the same tensors: the cache is preallocated once and decode
never copies it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.device import resolve_device


@dataclass
class KVCache:
    """Dense per-layer KV cache; tensors stacked over layers on axis 0."""

    k: torch.Tensor  # [L, B, n_kv, T, hd]
    v: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch_size: int,
               max_seq_len: Optional[int] = None, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        shape = (config.num_layers, batch_size, config.num_kv_heads,
                 max_seq_len or config.max_seq_len, config.head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


@dataclass
class QuantizedKVCache:
    """int8 KV cache: payload plus one f32 scale per (row, head, position)."""

    k: torch.Tensor        # int8 [L, B, n_kv, T, hd]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [L, B, n_kv, T]
    v_scale: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch_size: int,
               max_seq_len: Optional[int] = None,
               device=None) -> "QuantizedKVCache":
        s = max_seq_len or config.max_seq_len
        shape = (config.num_layers, batch_size, config.num_kv_heads, s,
                 config.head_dim)
        dev = resolve_device(device)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        )

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over head_dim: x ``[..., hd]`` → (int8, f32 scale
    ``[...]``). Multiplies by the reciprocal, as the reference does (its
    act-quant divides instead; each order is kept). 127 is a tensor on x's
    device so that the division is a true one on the card too."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax / absmax.new_full((), 127.0)
    inv = torch.where(scale == 0.0, torch.zeros_like(scale), 1.0 / scale)
    q = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """q int8 ``[..., T, hd]`` · scale f32 ``[..., T]`` → dtype."""
    return (q.float() * scale[..., None]).to(dtype)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start_pos) -> None:
    """cache ``[B, n_kv, T(, hd)]`` ← new ``[B, n_kv, S(, hd)]`` at a shared
    int or per-row ``[B]`` start position, in place."""
    s = new.shape[2]
    if torch.is_tensor(start_pos) and start_pos.ndim == 0:
        start_pos = int(start_pos)
    if isinstance(start_pos, int):
        cache[:, :, start_pos:start_pos + s] = new
        return
    for b, p in enumerate(start_pos.tolist()):
        cache[b, :, p:p + s] = new[b]


def update_layer_cache(cache_k, cache_v, k, v, start_pos):
    """Write k/v (``[B, S, n_kv, hd]``) head-major into one layer's cache
    ``[B, n_kv, T, hd]`` at ``start_pos``, in place."""
    _write_rows(cache_k, k.transpose(1, 2).to(cache_k.dtype), start_pos)
    _write_rows(cache_v, v.transpose(1, 2).to(cache_v.dtype), start_pos)
    return cache_k, cache_v


def update_layer_cache_quantized(cache_k, cache_v, k_scale, v_scale, k, v, start_pos):
    """Quantize k/v (``[B, S, n_kv, hd]``) and write payload and scales into
    one layer's cache at ``start_pos``, in place."""
    qk, sk = quantize_kv(k.transpose(1, 2))
    qv, sv = quantize_kv(v.transpose(1, 2))
    _write_rows(cache_k, qk, start_pos)
    _write_rows(cache_v, qv, start_pos)
    _write_rows(k_scale, sk, start_pos)
    _write_rows(v_scale, sv, start_pos)
    return cache_k, cache_v, k_scale, v_scale


def update_stacked_layer_cache(cache_k, cache_v, k, v, layer: int, start_pos):
    """Stacked-cache form of `update_layer_cache` at ``[layer]``, in place."""
    update_layer_cache(cache_k[layer], cache_v[layer], k, v, start_pos)
    return cache_k, cache_v


def update_stacked_layer_cache_quantized(cache_k, cache_v, k_scale, v_scale, k, v,
                                         layer: int, start_pos):
    """Stacked-cache form of `update_layer_cache_quantized`, in place."""
    update_layer_cache_quantized(cache_k[layer], cache_v[layer], k_scale[layer],
                                 v_scale[layer], k, v, start_pos)
    return cache_k, cache_v, k_scale, v_scale
