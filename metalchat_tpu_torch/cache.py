"""KV caches (port of the JAX package's ``cache.py``: dense, int8, paged).

Layouts match the JAX package: payload ``[L, B, n_kv, T, hd]`` head-major,
int8 scales flat ``[L, B, n_kv, T]`` in f32; paged pools ``[L, n_kv, P+1,
psize, hd]`` with page-major scales ``[L, P+1, n_kv, psize]``. Unlike the
JAX package, whose arrays are immutable, every update here writes the cache
tensors IN PLACE and returns the same tensors: the cache is preallocated
once and decode never copies it.
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
    """cache ``[B, n_kv, T(, hd)]`` ← new ``[B, n_kv, S(, hd)]`` at
    ``start_pos``, in place. An int writes a slice. An integer tensor, 0-d
    (shared) or ``[B]`` (per row), writes through indices computed on the
    cache's device and reads nothing back, so a captured window can write
    with it; both routes write the same bytes."""
    s = new.shape[2]
    if not torch.is_tensor(start_pos):
        cache[:, :, start_pos:start_pos + s] = new
        return
    b, dev = cache.shape[0], cache.device
    offsets = start_pos.to(device=dev, dtype=torch.int64).reshape(-1).expand(b)
    positions = offsets[:, None] + torch.arange(s, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]
    # Advanced indices on dims 0 and 2 around a slice move first: [B, S, n_kv(, hd)].
    cache[rows, :, positions] = new.transpose(1, 2)


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


def roll_kv_cache(cache, num_sink: int, shift: int):
    """Attention-sinks eviction, in place: keep positions ``[0, num_sink)``,
    move the rest left by ``shift`` and zero the last ``shift`` positions
    (the JAX package's ``roll_kv_cache``). Dense and int8 caches; every
    tensor keeps its storage, since a decode step captured in a CUDA graph
    goes on reading it, so the moved slice goes through a temporary copy
    (source and destination overlap). Returns the same cache."""
    if isinstance(cache, QuantizedKVCache):
        tensors = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    elif isinstance(cache, KVCache):
        tensors = (cache.k, cache.v)
    else:
        raise TypeError(f"roll_kv_cache takes a dense or int8 cache, not {type(cache).__name__}")
    for t in tensors:  # the position axis is 3 in payloads and scales
        body = t[:, :, :, num_sink + shift:].clone()
        t[:, :, :, num_sink:num_sink + body.shape[3]] = body
        t[:, :, :, t.shape[3] - shift:] = 0
    return cache


# ---------------------------------------------------------------- paged KV

@dataclass
class PagedKVCache:
    """int8 KV pages shared by all rows, addressed through a page table.

    ``num_pages + 1`` physical pages: the last one is the reserved garbage
    page, also the engine's sentinel table entry. Rows whose table entry is
    the sentinel write there and read masked garbage from there, never a
    live page. The allocator hands out pages ``[0, num_pages)`` only."""

    k_pages: torch.Tensor     # int8 [L, n_kv, P+1, psize, hd]
    v_pages: torch.Tensor
    k_scale: torch.Tensor     # f32 [L, P+1, n_kv, psize] (page-major, flat)
    v_scale: torch.Tensor
    page_table: torch.Tensor  # int32 [B, max_pages_per_seq]

    @classmethod
    def create(cls, config: ModelConfig, *, num_pages: int, page_size: int = 256,
               max_slots: int = 8, max_pages_per_seq: Optional[int] = None,
               device=None) -> "PagedKVCache":
        mps = max_pages_per_seq or -(-config.max_seq_len // page_size)
        shape = (config.num_layers, config.num_kv_heads, num_pages + 1, page_size,
                 config.head_dim)
        sshape = (config.num_layers, num_pages + 1, config.num_kv_heads, page_size)
        dev = resolve_device(device)
        return cls(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            page_table=torch.zeros((max_slots, mps), dtype=torch.int32, device=dev),
        )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[2]


def write_paged_layer(k_pages, v_pages, k_scale, v_scale, k_new, v_new, pages, offsets):
    """Quantize new K/V ``[B, S, n_kv, hd]`` and write them, in place, into
    one layer's pages ``[n_kv, P+1, psize, hd]`` / scales ``[P+1, n_kv,
    psize]`` at physical ``pages`` and in-page ``offsets`` (int ``[B, S]``,
    pages in ``[0, P]``). One indexed write per tensor, no host sync."""
    qk, sk = quantize_kv(k_new)   # [B, S, n_kv, hd], [B, S, n_kv]
    qv, sv = quantize_kv(v_new)
    pg, off = pages.reshape(-1).long(), offsets.reshape(-1).long()
    nkv, hd = qk.shape[2], qk.shape[3]
    # Advanced indices on adjacent dims 1, 2 keep their place: [n_kv, B·S, hd].
    k_pages[:, pg, off] = qk.reshape(-1, nkv, hd).transpose(0, 1)
    v_pages[:, pg, off] = qv.reshape(-1, nkv, hd).transpose(0, 1)
    # Advanced indices on dims 0 and 2 around a slice move first: [B·S, n_kv].
    k_scale[pg, :, off] = sk.reshape(-1, nkv)
    v_scale[pg, :, off] = sv.reshape(-1, nkv)
    return k_pages, v_pages, k_scale, v_scale


def update_stacked_paged_cache(k_pages, v_pages, k_scale, v_scale, k, v, layer: int,
                               page, offset):
    """Decode-path write of one new row per batch row (k, v ``[B, 1, n_kv,
    hd]``) into layer ``layer`` of the stacked pool at physical ``page`` and
    ``offset`` (int ``[B]``), in place. Sentinel rows write the garbage page."""
    write_paged_layer(k_pages[layer], v_pages[layer], k_scale[layer], v_scale[layer],
                      k, v, page[:, None], offset[:, None])
    return k_pages, v_pages, k_scale, v_scale


def _clamped(page_table: torch.Tensor, num_pages: int) -> torch.Tensor:
    return page_table.long().clamp(0, num_pages - 1)


def gather_pages_dense(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each row's pages as a dense, contiguous ``[B, n_kv, max_pages·psize,
    X]`` from ``pages [n_kv, P+1, psize, X]`` (the flash kernel takes it).
    Table entries are clamped into the pool (the sentinel reads the garbage
    page), never filled: a NaN fill would poison masked attention through
    0·NaN."""
    g = pages[:, _clamped(page_table, pages.shape[1])]  # [n_kv, B, mp, psize, X]
    n_kv, b, mp, psize, x = g.shape
    return g.transpose(0, 1).contiguous().view(b, n_kv, mp * psize, x)


def gather_page_scales(scales: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """`gather_pages_dense` for the scales ``[P+1, n_kv, psize]`` →
    ``[B, n_kv, max_pages·psize]``, clamped the same way."""
    g = scales[_clamped(page_table, scales.shape[0])]  # [B, mp, n_kv, psize]
    b, mp, n_kv, psize = g.shape
    return g.transpose(1, 2).contiguous().view(b, n_kv, mp * psize)


def positions_to_pages(page_table: torch.Tensor, positions: torch.Tensor,
                       page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page, in-page offset) of logical ``positions [B, S]``. A
    position past the table is an error (the engine's room clamp keeps
    padded chunks inside a row's pages)."""
    pos = positions.long()
    pages = torch.gather(page_table.long(), 1, pos // page_size)
    return pages, pos % page_size
