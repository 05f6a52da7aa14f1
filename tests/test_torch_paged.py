"""The port's paged KV cache, page allocator and paged decode attention
(plain versions) against the JAX package, on the CPU.

The JAX kernels run as Pallas in interpret mode. Inputs come from a numpy
seed: int8 pages with f32 scales, page tables shuffled so that a row's
pages are not contiguous, unallocated entries and one whole row at the
sentinel (the garbage page, index P). Attention outputs agree within
rtol = atol = 1e-5 at f32 (summation order only). Pages and scales are
byte-identical to the JAX package's reference write
(`update_stacked_paged_cache`, which its kernel mirrors) everywhere but the
garbage page, where several rows write in one step and the order is not
defined. The interpreted Pallas kernel itself computes the new row's scale
as absmax times a rounded 1/127, one ulp off that reference's true division
in some rows; its scales are held to that ulp and its pages exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu import cache as jcache
from metalchat_tpu.engine.paged import PageAllocator as JPageAllocator
from metalchat_tpu.ops import paged_attention_pallas as jpaged
from metalchat_tpu_torch import cache
from metalchat_tpu_torch.engine.paged import PageAllocator
from metalchat_tpu_torch.ops import paged_attention as paged

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

L, B, NH, NKV, HD, PSIZE, MP, P = 2, 4, 4, 2, 64, 16, 4, 12
SCALE = HD ** -0.5
# (lengths, window): length 1, a page edge and one past it, the table's
# last position, windows; row 3 is the sentinel row at position 0.
CASES = [([1, 16, 17, 64], None), ([64, 33, 5, 1], None), ([40, 64, 12, 1], 10),
         ([17, 2, 64, 1], 1)]


def _inputs(seed: int, lengths):
    rng = np.random.default_rng(seed)
    pages = rng.integers(-127, 128, (2, L, NKV, P + 1, PSIZE, HD)).astype(np.int8)
    scales = (rng.random((2, L, P + 1, NKV, PSIZE)) * 0.01).astype(np.float32)
    order = rng.permutation(P)
    table = np.full((B, MP), P, np.int32)
    for b, n in enumerate(lengths[:B - 1]):  # each live row owns its pages
        need = -(-n // PSIZE)
        table[b, :need] = order[b * MP:b * MP + need]
    q = rng.standard_normal((B, NH, HD)).astype(np.float32)
    new = rng.standard_normal((2, B, NKV, HD)).astype(np.float32)
    return pages, scales, table, np.asarray(lengths, np.int32), q, new


def _live(table, lengths):
    """Rows whose write position lies in a live page."""
    pos = lengths - 1
    return table[np.arange(B), pos // PSIZE] != P


@pytest.fixture(scope="module")
def jax_results():
    out = []
    for i, (lengths, window) in enumerate(CASES):
        pages, scales, table, lens, q, new = _inputs(i, lengths)
        args = [jnp.asarray(a) for a in (pages[0], pages[1], scales[0], scales[1])]
        pos = jnp.asarray(lens - 1)
        ref = jcache.update_stacked_paged_cache(
            *args, jnp.asarray(new[0][:, None]), jnp.asarray(new[1][:, None]), 1,
            jnp.minimum(jnp.asarray(table)[jnp.arange(B), pos // PSIZE], P), pos % PSIZE)
        upd = jpaged.paged_decode_attention_update_stacked(
            jnp.asarray(q), jnp.asarray(new[0]), jnp.asarray(new[1]), *args,
            jnp.asarray(table), jnp.asarray(lens), 1, scale=SCALE, window=window,
            interpret=True)
        read = jpaged.paged_decode_attention_stacked(
            jnp.asarray(q), *args, jnp.asarray(table), jnp.asarray(lens), 0, scale=SCALE,
            window=window, interpret=True)
        one = jpaged.paged_decode_attention(
            jnp.asarray(q), *(a[1] for a in args), jnp.asarray(table), jnp.asarray(lens),
            scale=SCALE, window=window, interpret=True)
        out.append(([np.asarray(a) for a in upd], np.asarray(read), np.asarray(one),
                    [np.asarray(a) for a in ref]))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_update_mode_matches_jax(jax_results, case):
    lengths, window = CASES[case]
    pages, scales, table, lens, q, new = _inputs(case, lengths)
    kp, vp, ks, vs = _t(pages[0]), _t(pages[1]), _t(scales[0]), _t(scales[1])
    got = paged.paged_decode_attention_update_stacked(
        _t(q), _t(new[0]), _t(new[1]), kp, vp, ks, vs, _t(table), _t(lens), 1,
        scale=SCALE, window=window)
    want, ref = jax_results[case][0], jax_results[case][3]
    live = _live(table, lens)
    assert live.sum() == B - 1
    np.testing.assert_allclose(got[0].numpy()[live], want[0][live], rtol=1e-5, atol=1e-5)
    for g, w, r in zip(got[1:3], want[1:3], ref[:2]):  # pages: all but the garbage page
        np.testing.assert_array_equal(g.numpy()[:, :, :P], r[:, :, :P])
        np.testing.assert_array_equal(g.numpy()[:, :, :P], w[:, :, :P])
    for g, w, r in zip(got[3:], want[3:], ref[2:]):    # scales
        np.testing.assert_array_equal(g.numpy()[:, :P], r[:, :P])
        np.testing.assert_allclose(g.numpy()[:, :P], w[:, :P], rtol=2 ** -23, atol=0)
    assert not np.array_equal(got[1].numpy(), pages[0])  # the rows were written


@pytest.mark.parametrize("case", range(len(CASES)))
def test_read_only_modes_match_jax(jax_results, case):
    lengths, window = CASES[case]
    pages, scales, table, lens, q, _ = _inputs(case, lengths)
    kp, vp, ks, vs = _t(pages[0]), _t(pages[1]), _t(scales[0]), _t(scales[1])
    got = paged.paged_decode_attention_stacked(_t(q), kp, vp, ks, vs, _t(table), _t(lens),
                                               0, scale=SCALE, window=window)
    np.testing.assert_allclose(got.numpy(), jax_results[case][1], rtol=1e-5, atol=1e-5)
    one = paged.paged_decode_attention(_t(q), kp[1], vp[1], ks[1], vs[1], _t(table),
                                       _t(lens), scale=SCALE, window=window)
    np.testing.assert_allclose(one.numpy(), jax_results[case][2], rtol=1e-5, atol=1e-5)
    assert np.array_equal(kp.numpy(), pages[0])  # nothing was written


def test_plain_raises_on_a_length_outside_the_table():
    pages, scales, table, lens, q, new = _inputs(0, CASES[0][0])
    for bad in (0, MP * PSIZE + 1):
        lens[0] = bad
        with pytest.raises(ValueError, match="lengths must lie in"):
            paged.paged_decode_attention_stacked(
                _t(q), _t(pages[0]), _t(pages[1]), _t(scales[0]), _t(scales[1]),
                _t(table), _t(lens), 0, scale=SCALE)


def test_write_gather_round_trip_matches_jax():
    """write_paged_layer at positions_to_pages of [B, S] positions, rows 2-3
    all at the sentinel: the live pages and scales equal the JAX package's,
    and gathering them back returns the quantized rows."""
    rng = np.random.default_rng(7)
    s = 6
    pages = np.zeros((NKV, P + 1, PSIZE, HD), np.int8)
    scales = np.zeros((P + 1, NKV, PSIZE), np.float32)
    table = np.full((B, MP), P, np.int32)
    table[0, :2], table[1, :2] = [5, 2], [9, 0]
    positions = np.stack([np.arange(12, 12 + s), np.arange(3, 3 + s),
                          np.zeros(s, int), np.zeros(s, int)]).astype(np.int32)
    k_new = rng.standard_normal((B, s, NKV, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, s, NKV, HD)).astype(np.float32)

    jpg, joff = jcache.positions_to_pages(jnp.asarray(table), jnp.asarray(positions), PSIZE)
    want = jcache.write_paged_layer(*(jnp.asarray(a) for a in (pages, pages, scales, scales,
                                                               k_new, v_new)), jpg, joff)
    want_keys = np.asarray(jcache.gather_pages_dense(want[0], jnp.asarray(table)))
    want_ks = np.asarray(jcache.gather_page_scales(want[2], jnp.asarray(table)))

    pg, off = cache.positions_to_pages(_t(table), _t(positions), PSIZE)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jpg))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    got = cache.write_paged_layer(_t(pages), _t(pages), _t(scales), _t(scales),
                                  _t(k_new), _t(v_new), pg, off)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[:, :P], np.asarray(w)[:, :P])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy()[:P], np.asarray(w)[:P])
    keys = cache.gather_pages_dense(got[0], _t(table))
    ks = cache.gather_page_scales(got[2], _t(table))
    assert keys.shape == (B, NKV, MP * PSIZE, HD) and ks.shape == (B, NKV, MP * PSIZE)
    assert keys.is_contiguous() and ks.is_contiguous()  # as the kernels take them
    np.testing.assert_array_equal(keys.numpy()[:2], want_keys[:2])
    np.testing.assert_array_equal(ks.numpy()[:2], want_ks[:2])
    qk, sk = cache.quantize_kv(_t(k_new[:2]).transpose(1, 2))  # [2, n_kv, S, hd]
    for b in range(2):
        np.testing.assert_array_equal(keys[b][:, positions[b]].numpy(), qk[b].numpy())
        np.testing.assert_array_equal(ks[b][:, positions[b]].numpy(), sk[b].numpy())


def test_page_allocator_matches_jax():
    ours, theirs = PageAllocator(10), JPageAllocator(10)
    script = [("allocate", 0, 3), ("allocate", 1, 2), ("free", 0), ("allocate", 2, 4),
              ("allocate", 1, 1), ("free", 1), ("allocate", 0, 5)]
    for op, slot, *n in script:
        if op == "allocate":
            assert ours.allocate(slot, n[0]) == theirs.allocate(slot, n[0])
        else:
            ours.free_slot(slot)
            theirs.free_slot(slot)
        assert ours.free_pages == theirs.free_pages
    assert not ours.can_allocate(2) and ours.can_allocate(1)
    with pytest.raises(MemoryError):
        ours.allocate(3, 2)


def test_paged_cache_layout():
    from metalchat_tpu_torch.config import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=96, num_layers=L,
                      num_heads=NH, num_kv_heads=NKV, head_dim=HD, max_seq_len=MP * PSIZE)
    c = cache.PagedKVCache.create(cfg, num_pages=P, page_size=PSIZE, max_slots=B,
                                  device="cpu")
    assert c.k_pages.shape == (L, NKV, P + 1, PSIZE, HD) and c.k_pages.dtype == torch.int8
    assert c.k_scale.shape == (L, P + 1, NKV, PSIZE) and c.k_scale.dtype == torch.float32
    assert c.page_table.shape == (B, MP) and c.num_pages == P + 1 and c.page_size == PSIZE
