"""Paged int8-KV decode attention: CUDA kernel ``csrc/paged_attention.cu``
and its plain PyTorch version.

Replaces ``metalchat_tpu/ops/paged_attention_pallas.py``:

* ``paged_decode_attention_update_stacked``: quantize the new K/V row and
  write it, IN PLACE, into layer ``layer`` of the stacked pool at page
  ``min(page_table[b, pos // psize], P)``, offset ``pos % psize``, with
  ``pos = length - 1``; then single-token GQA attention over the row's
  pages in ``[window_lo, length)``. A sentinel entry writes the garbage page.
* ``paged_decode_attention_stacked``: the same attention without the write.
* ``paged_decode_attention``: the latter on one layer's pool.

One kernel serves all three, with a write flag. On the H100 it is bound by
the bytes of the int8 K/V rows it visits and, at few rows, by latency: the
kernel splits the positions over blocks of ``SPLIT_CHUNK`` positions (a
chunk may cross pages) and merges their partials in the same launch
(flash-decoding); see the CUDA source.

Layouts: q ``[B, nh, hd]`` (heads kv-major), new rows ``[B, n_kv, hd]``,
pages int8 ``[L, n_kv, P+1, psize, hd]``, scales f32 ``[L, P+1, n_kv,
psize]``, page table int32 ``[B, MP]``, lengths int32 ``[B]`` including the
new token, each in ``[1, MP·psize]``, window ``None`` or an int (``-1`` =
global). A row whose write page is the garbage page gets an undefined
output on the card, where the blocks of one launch race on that page.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from metalchat_tpu_torch.cache import (
    gather_page_scales,
    gather_pages_dense,
    positions_to_pages,
    update_stacked_paged_cache,
)
from metalchat_tpu_torch.ops import _build
from metalchat_tpu_torch.ops.decode_attention import SPLIT_CHUNK, attention_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    lib.paged_attention.argtypes = [_P] * 12 + [_I] * 8 + [_F, _I, _I, _I, _P]
    lib.paged_attention.restype = _I
    return lib


def _check_lengths(lengths, limit: int) -> None:
    if bool(((lengths < 1) | (lengths > limit)).any()):
        raise ValueError(f"paged_decode_attention: lengths must lie in [1, {limit}]")


def paged_decode_attention_plain(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                 lengths, layer: int, *, scale: float,
                                 window: Optional[int] = None) -> torch.Tensor:
    """Read-only mode: gather the row's pages (sentinels clamped onto the
    garbage page) and attend as the dense int8 cache does."""
    _check_lengths(lengths, page_table.shape[1] * k_pages.shape[3])
    k = gather_pages_dense(k_pages[layer], page_table)
    v = gather_pages_dense(v_pages[layer], page_table)
    ks = gather_page_scales(k_scale[layer], page_table)
    vs = gather_page_scales(v_scale[layer], page_table)
    return attention_plain(q, k, v, ks, vs, lengths, scale=scale, window=window)


def paged_decode_attention_update_plain(q, k_new, v_new, k_pages, v_pages, k_scale,
                                        v_scale, page_table, lengths, layer: int, *,
                                        scale: float, window: Optional[int] = None):
    """Write mode: the new row into its page, then `paged_decode_attention_plain`."""
    _check_lengths(lengths, page_table.shape[1] * k_pages.shape[3])
    pos = (lengths.long() - 1)[:, None]
    page, off = positions_to_pages(page_table, pos, k_pages.shape[3])
    page = page.clamp(0, k_pages.shape[2] - 1)
    update_stacked_paged_cache(k_pages, v_pages, k_scale, v_scale, k_new[:, None],
                               v_new[:, None], layer, page[:, 0], off[:, 0])
    out = paged_decode_attention_plain(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                       lengths, layer, scale=scale, window=window)
    return out, k_pages, v_pages, k_scale, v_scale


def check_args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer: int,
               k_new=None, v_new=None) -> None:
    """The kernel's preconditions on shapes and dtypes (it indexes the pool
    with k_pages' strides and writes into it in place). Lengths and table
    entries are data on the card and are not checked here: the kernel
    clamps entries into the pool, and for a row whose length is outside
    ``[1, MP·psize]`` it leaves the pool untouched and returns NaN."""
    b, nh, hd = q.shape
    L, nkv, num_pages, psize, _ = k_pages.shape
    mp = page_table.shape[-1]
    if (k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("paged_decode_attention: int8 pages with f32 scales")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("paged_decode_attention: q bf16 or f32")
    if k_new is not None and (k_new.dtype != q.dtype or v_new.dtype != q.dtype
                              or k_new.shape != (b, nkv, hd)
                              or v_new.shape != k_new.shape):
        raise ValueError("paged_decode_attention: k_new/v_new [B, n_kv, hd] in q's dtype")
    if (v_pages.shape != k_pages.shape or k_pages.shape[-1] != hd
            or k_scale.shape != (L, num_pages, nkv, psize) or v_scale.shape != k_scale.shape
            or nh % nkv or page_table.shape != (b, mp) or page_table.dtype != torch.int32
            or lengths.shape != (b,) or lengths.dtype != torch.int32):
        raise ValueError("paged_decode_attention: shape mismatch")
    if hd not in (64, 128) or nh // nkv > 32 or not 0 <= layer < L:
        raise ValueError(f"paged_decode_attention: hd in (64, 128), groups <= 32 and "
                         f"0 <= layer < {L}, got hd={hd}, groups={nh // nkv}, "
                         f"layer={layer}")


def _launch(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
            layer: int, scale: float, window: Optional[int]) -> torch.Tensor:
    write = k_new is not None
    name = "paged_decode_attention_update" if write else "paged_decode_attention"
    extra = (k_new, v_new) if write else ()
    _build.require_cuda(name, q, *extra, k_pages, v_pages, k_scale, v_scale, page_table,
                        lengths)
    check_args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
               k_new, v_new)
    b, nh, hd = q.shape
    _, nkv, num_pages, psize, _ = k_pages.shape
    mp = page_table.shape[1]
    out = torch.empty_like(q)
    # The f32 partials of every query head and chunk of SPLIT_CHUNK positions.
    n_split = -(-mp * psize // SPLIT_CHUNK)
    ws = torch.empty(b * nh * n_split * (hd + 2), dtype=torch.float32, device=q.device)
    rc = _lib().paged_attention(
        q.data_ptr(), k_new.data_ptr() if write else None,
        v_new.data_ptr() if write else None, k_pages[layer].data_ptr(),
        v_pages[layer].data_ptr(), k_scale[layer].data_ptr(), v_scale[layer].data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _build.arrival_counters(q.device, b * nkv).data_ptr(), b, nh, nkv, num_pages, psize,
        mp, hd, SPLIT_CHUNK, float(scale), -1 if window is None else int(window), int(write),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(rc, name)
    _build.count_launch(name)
    return out


def paged_decode_attention_update_stacked(q, k_new, v_new, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths, layer: int, *,
                                          scale: float, window: Optional[int] = None):
    """Quantize + write the new row into its page of layer ``layer`` in
    place, then attend. Returns ``(attn [B, nh, hd], k_pages, v_pages,
    k_scale, v_scale)``."""
    if q.device.type == "cpu":
        return paged_decode_attention_update_plain(
            q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
            layer, scale=scale, window=window)
    out = _launch(q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, page_table,
                  lengths, layer, scale, window)
    return out, k_pages, v_pages, k_scale, v_scale


def paged_decode_attention_stacked(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                   lengths, layer: int, *, scale: float,
                                   window: Optional[int] = None) -> torch.Tensor:
    """Attention over layer ``layer`` of the stacked pool, no write."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, k_scale, v_scale,
                                            page_table, lengths, layer, scale=scale,
                                            window=window)
    return _launch(q, None, None, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                   layer, scale, window)


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, *,
                           scale: float, window: Optional[int] = None) -> torch.Tensor:
    """One layer's pool: pages ``[n_kv, P, psize, hd]``, scales ``[P, n_kv,
    psize]``; the stacked form on a one-layer view."""
    return paged_decode_attention_stacked(
        q, k_pages[None], v_pages[None], k_scale[None], v_scale[None], page_table,
        lengths, 0, scale=scale, window=window)
