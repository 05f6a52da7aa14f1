"""`chip_smoke.py`'s kernel checks can fail.

On the CPU each kernel wrapper is its plain version, so the checks compare
the plain version with itself. Here the wrapper is replaced by a faulty
one: the new row left out of the attention, a causal or window edge one
position off, or one position's v-scale wrong (for the read-only decode
mode, the last cache position left out); for the paged kernel also
the new row written into the neighbouring page and a page-table lookup off
by one; for the dequant matmul a wrong group index and swapped nibble
halves; for the merged FFN block a missing residual and one output tile
off by one column, and in its ring schedule (emulated) phase C on phase B's
codes, a prefetched w13 tile from the next layer, one row's scale taken
from its neighbour and a ring slot refilled one stage early; for the
matvec's raw mode (the int8 tensor-core schedule, emulated) a dropped k
step, the int4 correction left out, and a padded code column stored into
row B - 1. Each must fail the check. For the FFN block's phase B, two
norm codes moved by a quantum (at 2464 and 3159, where the card moved them
on one draw) must pass when the block reports the codes it used and fail when
it does not, and more than ``FFN_MOVED_CODES`` moved codes in a row fail.
A wrapper that differs from the plain version only by f32 rounding noise
must pass. The shapes are the fixture's (hd=64).

The redesigned kernels' own rounding is emulated too. Decode attention
split over chunks of ``SPLIT_CHUNK`` positions and merged in f32 must pass;
leaving out the chunk that holds the new token must fail. The same for the
paged kernel at pages of 4, 16, 48 and 256 positions, where a chunk may
cross pages: reading a chunk's rows all from its first page must fail. Flash attention
with P split into two bf16 parts (hi + lo) must pass; with P rounded to one
bf16, as FlashAttention-2 usually does, it must fail: the check's limit is
why the kernel splits P.

mixtral-fixture's routing check (`chip_smoke.check_routed_logits`): one
token routed to another expert on the "card" side (a forced flip of its
K-th and (K+1)-th choices at a router near tie, as two sum orders can flip
them) fails the plain logit check; the routing check names that step,
layer and token and passes; with an expert's output wrong as well it
fails, and so does a flip at a router gap above `chip_smoke.ROUTER_TIE_GAP`
(the token's first choice dropped), which no drift explains.
"""

import importlib

import pytest
import torch

import chip_smoke
from metalchat_tpu_torch.ops.reference import MASK_VALUE
from torch_port_util import a8_mma_emulate, ffn_block_emulate

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

decode_mod = importlib.import_module("metalchat_tpu_torch.ops.decode_attention")
flash_mod = importlib.import_module("metalchat_tpu_torch.ops.flash_attention")
CPU = torch.device("cpu")


def _noisy(out, dtype):
    """f32 results a right kernel could give: summation order moves them
    by about 1e-6 relative before the cast."""
    gen = torch.Generator().manual_seed(0)
    return (out * (1 + 1e-6 * torch.randn(out.shape, generator=gen))).to(dtype)


def _split_attention(q, k, v, k_scale, v_scale, lengths, *, scale, window=None,
                     drop_last=False):
    """Decode attention as the split kernel computes it: f32 partials (m, l,
    acc) per chunk of SPLIT_CHUNK positions, merged in chunk order with
    weights exp(m - max m). ``drop_last`` leaves out the chunk of length - 1."""
    c = decode_mod.SPLIT_CHUNK
    b, nh, hd = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    n_split = -(-t_max // c)
    pad = n_split * c - t_max
    s = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(b, nkv, nh // nkv, hd),
                     k.float()) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    t = torch.arange(t_max)[None, :]
    length = lengths.long()[:, None]
    ok = t < length
    if window is not None and window >= 0:
        ok &= t > length - 1 - window
    if drop_last:
        ok &= t // c != (length - 1) // c
    vsc = torch.ones(b, nkv, t_max) if v_scale is None else v_scale
    ok, vsc = (torch.nn.functional.pad(x, (0, pad)) for x in (ok, vsc))
    s = torch.nn.functional.pad(s, (0, pad)).reshape(b, nkv, nh // nkv, n_split, c)
    okc = ok.reshape(b, 1, 1, n_split, c)
    m = torch.where(okc, s, -torch.inf).amax(-1)                   # [b, k, g, n_split]
    p = torch.where(okc, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    pv = p * vsc.reshape(b, nkv, 1, n_split, c)
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).reshape(b, nkv, n_split, c, hd)
    acc = torch.einsum("bkgsc,bkscd->bkgsd", pv, vv)
    big = m.amax(-1, keepdim=True)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - big))
    l = (w * l).sum(-1, keepdim=True)
    o = (w[..., None] * acc).sum(-2) * torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return o.reshape(b, nh, hd).to(q.dtype)


def test_split_emulation_is_the_plain_attention():
    gen = torch.Generator().manual_seed(3)
    b, nh, nkv, t_max, hd = 3, 6, 3, 100, 64
    q = torch.randn((b, nh, hd), generator=gen, dtype=torch.float64).float()
    k, v = (torch.randint(-127, 128, (b, nkv, t_max, hd), generator=gen, dtype=torch.int8)
            for _ in range(2))
    ks, vs = (torch.rand((b, nkv, t_max), generator=gen) * 0.01 for _ in range(2))
    lengths = torch.tensor([1, 33, 100], dtype=torch.int32)
    for window in (None, 40, 1):
        want = decode_mod.attention_plain(q, k, v, ks, vs, lengths, scale=0.125, window=window)
        got = _split_attention(q, k, v, ks, vs, lengths, scale=0.125, window=window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _faulty_decode(fault):
    plain = decode_mod.decode_attention_update_plain

    def update(q, kn, vn, k, v, ks, vs, layer, lengths, *, scale, window=None):
        out, *cache = plain(q.float(), kn.float(), vn.float(), k, v, ks, vs, layer,
                            lengths, scale=scale, window=window)
        if fault == "noise":
            return _noisy(out, q.dtype), *cache
        if fault in ("split", "split_drop_last"):
            return _split_attention(q, k[layer], v[layer], ks[layer], vs[layer], lengths,
                                    scale=scale, window=window,
                                    drop_last=fault == "split_drop_last"), *cache
        b, nh, hd = q.shape
        nkv, t_max = k.shape[2], k.shape[3]
        s = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(b, nkv, nh // nkv, hd),
                         k[layer].float()) * scale * ks[layer][:, :, None, :]
        t = torch.arange(t_max)[None, :]
        length = lengths.long()[:, None]
        ok = t < (length - 1 if fault == "drop_new" else length)
        if window is None:
            ok &= t >= (1 if fault == "edge" else 0)
        else:
            ok &= t > length - 1 - window - (1 if fault == "edge" else 0)
        v_scale = vs[layer].clone()
        if fault == "v_scale":
            v_scale[torch.arange(b), :, (length[:, 0] - 1) // 2] = 1.0 / 127
        s = torch.where(ok[:, None, None, :], s, MASK_VALUE)
        p = torch.where(ok[:, None, None, :], torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bkgt,bktd->bkgd", p * v_scale[:, :, None, :], v[layer].float())
        o = o / torch.where(l == 0, torch.ones_like(l), l)
        return o.reshape(b, nh, hd).to(q.dtype), *cache

    return update


def _run_decode(monkeypatch, fault, case):
    monkeypatch.setattr(decode_mod, "decode_attention_update_quantized_stacked",
                        _faulty_decode(fault))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_decode(sm, 3, 6, 3, 256, 64, [case], torch.Generator().manual_seed(1),
                            CPU)
    return sm


@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_FIXTURE, ids=str)
def test_decode_check_passes_rounding_noise(monkeypatch, case):
    sm = _run_decode(monkeypatch, "noise", case)
    assert sm.share["decode_attention_update"] <= 1.0


@pytest.mark.parametrize("case", chip_smoke.DECODE_CASES_FIXTURE, ids=str)
def test_decode_check_passes_the_split_merge(monkeypatch, case):
    sm = _run_decode(monkeypatch, "split", case)
    assert sm.share["decode_attention_update"] <= 1.0


# v_scale: the wrong position lies inside the attended range only in the
# first two cases (the others attend a window or a zeroed cache there).
@pytest.mark.parametrize("fault,case", [
    *(("drop_new", c) for c in chip_smoke.DECODE_CASES_FIXTURE),
    *(("edge", c) for c in chip_smoke.DECODE_CASES_FIXTURE),
    *(("v_scale", c) for c in chip_smoke.DECODE_CASES_FIXTURE[:2]),
    *(("split_drop_last", c) for c in chip_smoke.DECODE_CASES_FIXTURE)], ids=str)
def test_decode_check_fails_a_one_row_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_decode(monkeypatch, fault, case)


def _faulty_read(fault):
    def read(q, k, v, *rest, scale, window=None):
        ks, vs, layer, lengths = rest if len(rest) == 4 else (None, None, *rest)
        scales = [None if t is None else t[layer] for t in (ks, vs)]
        if fault == "noise":
            out = decode_mod.attention_plain(q.float(), k[layer], v[layer], *scales, lengths,
                                             scale=scale, window=window)
            return _noisy(out, q.dtype)
        if fault in ("split", "split_drop_last"):
            return _split_attention(q, k[layer], v[layer], *scales, lengths, scale=scale,
                                    window=window, drop_last=fault == "split_drop_last")
        return decode_mod.attention_plain(q, k[layer], v[layer], *scales, lengths - 1,
                                          scale=scale, window=window)

    return read


def _run_read(monkeypatch, fault, kv, case):
    for name in ("decode_attention_stacked", "decode_attention_quantized_stacked"):
        monkeypatch.setattr(decode_mod, name, _faulty_read(fault))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_decode_read(sm, 3, 6, 3, 256, 64, [case],
                                 torch.Generator().manual_seed(1), CPU, kv=kv)
    return sm


@pytest.mark.parametrize("kv", ["act", "int8"])
@pytest.mark.parametrize("case", chip_smoke.READ_CASES_FIXTURE, ids=str)
def test_decode_read_check_passes_rounding_noise(monkeypatch, kv, case):
    assert _run_read(monkeypatch, "noise", kv, case).share["decode_attention"] <= 1.0


@pytest.mark.parametrize("kv", ["act", "int8"])
@pytest.mark.parametrize("case", chip_smoke.READ_CASES_FIXTURE, ids=str)
def test_decode_read_check_fails_a_dropped_last_row(monkeypatch, kv, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_read(monkeypatch, "drop_last", kv, case)


@pytest.mark.parametrize("kv", ["act", "int8"])
@pytest.mark.parametrize("case", chip_smoke.READ_CASES_FIXTURE, ids=str)
def test_decode_read_check_passes_the_split_merge(monkeypatch, kv, case):
    assert _run_read(monkeypatch, "split", kv, case).share["decode_attention"] <= 1.0


@pytest.mark.parametrize("kv", ["act", "int8"])
@pytest.mark.parametrize("case", chip_smoke.READ_CASES_FIXTURE, ids=str)
def test_decode_read_check_fails_a_dropped_last_chunk(monkeypatch, kv, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_read(monkeypatch, "split_drop_last", kv, case)


def test_smoke_chunk_is_the_kernels():
    assert chip_smoke.SPLIT_CHUNK == decode_mod.SPLIT_CHUNK


def _p_rounded_flash(q, k, v, start, *, scale, window=None, split=True):
    """Flash attention with P rounded for a bf16 PV product: hi = bf16(p),
    and with ``split`` also lo = bf16(p - hi), each product summed in f32;
    the row sum from the f32 p (the tensor-core kernel's arithmetic)."""
    b, s, nh, hd = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    q_pos = flash_mod._starts(start, b, q.device).long()[:, None] + torch.arange(s)[None, :]
    kv_pos = torch.arange(t_max)[None, None, :]
    ok = kv_pos <= q_pos[:, :, None]
    if window is not None and window >= 0:
        ok &= kv_pos > q_pos[:, :, None] - window
    scores = torch.einsum("bskgd,bktd->bkgst", q.float().reshape(b, s, nkv, nh // nkv, hd),
                          k.float()) * scale
    scores = torch.where(ok[:, None, None], scores, MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    o = torch.einsum("bkgst,bktd->bkgsd", hi, v.float())
    if split:
        lo = (p - hi).to(torch.bfloat16).float()
        o = o + torch.einsum("bkgst,bktd->bkgsd", lo, v.float())
    o = o * torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd).to(q.dtype)


def _faulty_flash(fault):
    plain = flash_mod.flash_attention_plain

    def flash(q, k, v, start, *, scale, window=None):
        if fault == "noise":
            out = plain(q.float(), k.float(), v.float(), start, scale=scale, window=window)
            return _noisy(out, q.dtype)
        if fault in ("p_split", "p_bf16"):
            return _p_rounded_flash(q, k, v, start, scale=scale, window=window,
                                    split=fault == "p_split")
        if window is None:  # every query one position early: its causal edge
            return plain(q, k, v, start - 1, scale=scale)
        return plain(q, k, v, start, scale=scale, window=window + 1)

    return flash


def _run_flash(monkeypatch, fault, case):
    monkeypatch.setattr(flash_mod, "flash_attention", _faulty_flash(fault))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_flash(sm, 3, 48, 6, 3, 256, 64, [case], torch.Generator().manual_seed(1),
                           CPU)
    return sm


@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_FIXTURE, ids=str)
def test_flash_check_passes_rounding_noise(monkeypatch, case):
    sm = _run_flash(monkeypatch, "noise", case)
    assert sm.share["flash_attention"] <= 1.0


@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_FIXTURE, ids=str)
def test_flash_check_passes_p_split_into_two_bf16_parts(monkeypatch, case):
    sm = _run_flash(monkeypatch, "p_split", case)
    assert sm.share["flash_attention"] <= 1.0


@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_FIXTURE, ids=str)
def test_flash_check_fails_an_edge_fault(monkeypatch, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_flash(monkeypatch, "edge", case)


# Every case but the last, whose window of 1 leaves p = 1 alone in each row,
# exact in bf16.
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES_FIXTURE[:3], ids=str)
def test_flash_check_fails_p_rounded_to_bf16(monkeypatch, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_flash(monkeypatch, "p_bf16", case)


paged_mod = importlib.import_module("metalchat_tpu_torch.ops.paged_attention")


def _faulty_paged(fault):
    """Paged wrappers with one planted fault: the new row written into the
    neighbouring page, logical page i read through table entry i + 1, the
    window's lower edge one position early, or position length - 2 read
    with a wrong v-scale. Each mode keeps the right write unless the fault
    is the write."""
    update_plain = paged_mod.paged_decode_attention_update_plain
    read_plain = paged_mod.paged_decode_attention_plain

    def read(q, kp, vp, ks, vs, table, lengths, layer, *, scale, window=None):
        if fault == "noise":
            return _noisy(read_plain(q.float(), kp, vp, ks, vs, table, lengths, layer,
                                     scale=scale, window=window), q.dtype)
        if fault == "lookup":
            table = torch.cat([table[:, 1:], table[:, -1:]], dim=1)
        if fault == "window_edge":
            window += 1
        if fault == "v_scale":
            vs = vs.clone()
            psize, last = kp.shape[3], kp.shape[2] - 1
            pos = (lengths.long() - 2).clamp(min=0)
            page = table.long().gather(1, (pos // psize)[:, None])[:, 0].clamp(max=last)
            vs[layer][page, :, pos % psize] = 1.0 / 127
        return read_plain(q, kp, vp, ks, vs, table, lengths, layer, scale=scale,
                          window=window)

    def update(q, kn, vn, kp, vp, ks, vs, table, lengths, layer, *, scale, window=None):
        before = [t[layer].clone() for t in (kp, vp, ks, vs)]
        out, *cache = update_plain(q, kn, vn, kp, vp, ks, vs, table, lengths, layer,
                                   scale=scale, window=window)
        if fault == "neighbour_page":
            psize, last = kp.shape[3], kp.shape[2] - 1
            pos = lengths.long() - 1
            page = table.long().gather(1, (pos // psize)[:, None])[:, 0]
            live = page < last
            page, off = page[live], (pos % psize)[live]
            for t, old in zip((kp, vp), before[:2]):
                row = t[layer][:, page, off].clone()
                t[layer][:, page, off] = old[:, page, off]
                t[layer][:, page + 1, off] = row
            for t, old in zip((ks, vs), before[2:]):
                row = t[layer][page, :, off].clone()
                t[layer][page, :, off] = old[page, :, off]
                t[layer][page + 1, :, off] = row
            return out, *cache
        return read(q, kp, vp, ks, vs, table, lengths, layer, scale=scale,
                    window=window), *cache

    return update, read


def _run_paged(monkeypatch, fault, case):
    update, read = _faulty_paged(fault)
    monkeypatch.setattr(paged_mod, "paged_decode_attention_update_stacked", update)
    monkeypatch.setattr(paged_mod, "paged_decode_attention_stacked", read)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_paged(sm, 4, 6, 3, 64, 16, 8, [case], torch.Generator().manual_seed(1),
                           CPU)
    return sm


@pytest.mark.parametrize("case", chip_smoke.PAGED_CASES_FIXTURE, ids=str)
def test_paged_check_passes_rounding_noise(monkeypatch, case):
    sm = _run_paged(monkeypatch, "noise", case)
    assert sm.share["paged_decode_attention_update"] <= 1.0
    assert sm.share["paged_decode_attention"] <= 1.0


# window_edge: only the cases with a window; v_scale: position length - 2
# lies inside the attended range in the first three cases.
@pytest.mark.parametrize("fault,case", [
    *(("neighbour_page", c) for c in chip_smoke.PAGED_CASES_FIXTURE),
    *(("lookup", c) for c in chip_smoke.PAGED_CASES_FIXTURE),
    *(("window_edge", c) for c in chip_smoke.PAGED_CASES_FIXTURE[2:]),
    *(("v_scale", c) for c in chip_smoke.PAGED_CASES_FIXTURE[:3])], ids=str)
def test_paged_check_fails_a_planted_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit|not bit-exact"):
        _run_paged(monkeypatch, fault, case)


def _split_paged(q, kp, vp, ks, vs, table, lengths, layer, *, scale, window=None,
                 fault=None):
    """Paged attention as the split kernel reads it: position t from the
    page the table gives for t, chunks of SPLIT_CHUNK positions merged in
    chunk order (``_split_attention``). ``fault``: "first_page" reads every
    row of a chunk from the page of the chunk's first position, "drop_new"
    leaves out the chunk of length - 1."""
    psize, last = kp.shape[3], kp.shape[2] - 1
    mp = table.shape[1]
    t = torch.arange(mp * psize)
    src = t - t % decode_mod.SPLIT_CHUNK if fault == "first_page" else t
    page = table.long()[:, src // psize].clamp(0, last)             # [B, T]
    off = t % psize
    k, v = (x[layer][:, page, off].permute(1, 0, 2, 3) for x in (kp, vp))
    k_sc, v_sc = (x[layer][page, :, off].permute(0, 2, 1) for x in (ks, vs))
    return _split_attention(q, k, v, k_sc, v_sc, lengths, scale=scale, window=window,
                            drop_last=fault == "drop_new")


def _run_paged_split(monkeypatch, fault, psize, case):
    """check_paged with both modes read as the split kernel reads (the
    write as the plain version makes it)."""
    update_plain = paged_mod.paged_decode_attention_update_plain

    def read(q, kp, vp, ks, vs, table, lengths, layer, *, scale, window=None):
        return _split_paged(q, kp, vp, ks, vs, table, lengths, layer, scale=scale,
                            window=window, fault=fault)

    def update(q, kn, vn, kp, vp, ks, vs, table, lengths, layer, *, scale, window=None):
        _, *cache = update_plain(q, kn, vn, kp, vp, ks, vs, table, lengths, layer,
                                 scale=scale, window=window)
        return read(q, kp, vp, ks, vs, table, lengths, layer, scale=scale,
                    window=window), *cache

    monkeypatch.setattr(paged_mod, "paged_decode_attention_update_stacked", update)
    monkeypatch.setattr(paged_mod, "paged_decode_attention_stacked", read)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_paged(sm, 4, 6, 3, 64, psize, PAGED_SPLIT_MP[psize], [case],
                           torch.Generator().manual_seed(1), CPU)
    return sm


# Pages of 4 and 16 (several to a chunk), 48 (chunks straddle page edges
# at changing offsets) and 256 (a page holds 8 chunks), at the fixture's
# widths: pages a row and cases.
PAGED_SPLIT_MP = {4: 32, 16: 8, 48: 4, 256: 1}
PAGED_SPLIT_CASES = {
    4: chip_smoke.PAGED_CASES_P4, 16: chip_smoke.PAGED_CASES_FIXTURE,
    48: [([31, 65, 190, 1], None), ([97, 33, 150, 1], 50)],
    256: [([1, 256, 129, 1], None), ([200, 33, 256, 1], 40)]}


@pytest.mark.parametrize("psize,case", [(p, c) for p, cs in PAGED_SPLIT_CASES.items()
                                        for c in cs], ids=str)
def test_paged_check_passes_the_split_merge(monkeypatch, psize, case):
    sm = _run_paged_split(monkeypatch, None, psize, case)
    assert sm.share["paged_decode_attention_update"] <= 1.0
    assert sm.share["paged_decode_attention"] <= 1.0


# first_page: every case whose live rows have a chunk that crosses a page
# (pages of 4, 16 and 48; a page of 256 never splits a chunk).
@pytest.mark.parametrize("fault,psize,case", [
    *(("first_page", p, c) for p in (4, 16, 48) for c in PAGED_SPLIT_CASES[p]),
    *(("drop_new", p, c) for p, cs in PAGED_SPLIT_CASES.items() for c in cs)], ids=str)
def test_paged_check_fails_a_split_fault(monkeypatch, fault, psize, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_paged_split(monkeypatch, fault, psize, case)


qmm_mod = importlib.import_module("metalchat_tpu_torch.ops.quant_matmul")


def _faulty_qmm(fault):
    plain = qmm_mod.dequant_matmul_plain

    def qmm(x, q, s, *, bits, group_size, transposed):
        if fault == "noise":  # the weight in x's dtype, noise on the f32 sums
            w = qmm_mod.dequant_weight(q, s, bits=bits, group_size=group_size,
                                       transposed=transposed, dtype=x.dtype)
            return _noisy(x.float() @ w.float(), x.dtype)
        if fault == "group":  # each group reads its neighbour's scale
            s = s.roll(1, dims=1 if transposed else 0)
        if fault == "nibbles":  # input r reads the high nibble, r + in/2 the low
            lo, hi = (q & 15) - 8, q >> 4
            q = (((hi + 8) & 15) | ((lo & 15) << 4)).to(torch.int8)
        return plain(x, q, s, bits=bits, group_size=group_size, transposed=transposed)

    return qmm


def _run_qmm(monkeypatch, fault, shapes, dtype):
    monkeypatch.setattr(qmm_mod, "dequant_matmul", _faulty_qmm(fault))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_qmm(sm, shapes, 3, torch.Generator().manual_seed(1), CPU,
                         getattr(torch, dtype))
    return sm


GROUPED = [c for c in chip_smoke.QMM_FIXTURE if c[4] < c[2]]
INT4 = [c for c in chip_smoke.QMM_FIXTURE if c[3] == 4]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", chip_smoke.QMM_FIXTURE, ids=str)
def test_qmm_check_passes_rounding_noise(monkeypatch, case, dtype):
    assert _run_qmm(monkeypatch, "noise", [case], dtype).share["quant_matmul"] <= 1.0


@pytest.mark.parametrize("fault,case", [*(("group", c) for c in GROUPED),
                                        *(("nibbles", c) for c in INT4)], ids=str)
def test_qmm_check_fails_a_planted_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_qmm(monkeypatch, fault, [case], "bfloat16")


ffn_mod = importlib.import_module("metalchat_tpu_torch.ops.ffn_block")


def _faulty_ffn(fault):
    plain = ffn_mod.ffn_block_plain

    def ffn(attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s, layer, *, bits, act,
            eps, offset=0.0, scratch=None):
        if fault == "noise":  # the dtype's roundings kept, noise on f32 values
            x2 = ffn_mod.wo_stage(attn, x, wo_q[layer], wo_s[layer], bits=bits)
            _, gate, up, _ = ffn_mod.w13_stage(x2, norm_w[layer], w13_q[layer],
                                               w13_s[layer], bits=bits, act=act, eps=eps,
                                               offset=offset)
            h = _noisy(ffn_mod.activation(gate, act) * up, x.dtype)
            w2_out = ffn_mod.w2_stage(h, torch.zeros_like(x2), w2_q[layer], w2_s[layer],
                                      bits=bits)[0]
            codes = a8_mod.prologue(x2, norm_w[layer], eps, offset)[0]
            scratch.update(x2=x2, h=h, norm_codes=codes)
            return _noisy(x2.float() + w2_out.float(), x.dtype)
        out = plain(attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s, layer, bits=bits,
                    act=act, eps=eps, offset=offset, scratch=scratch)
        if fault == "residual":  # out = w2(h), x2 never added
            return out - scratch["x2"]
        out = out.clone()  # "tile": columns 32..63 read one column late
        out[:, 32:64] = out[:, 33:65]
        return out

    return ffn


def _run_ffn(monkeypatch, fault, case, dtype):
    monkeypatch.setattr(ffn_mod, "ffn_block_stacked", _faulty_ffn(fault))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_ffn_block(sm, 384, 1024, 3, [case], torch.Generator().manual_seed(1),
                               CPU, getattr(torch, dtype))
    return sm


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", chip_smoke.FFN_CASES, ids=str)
def test_ffn_check_passes_rounding_noise(monkeypatch, case, dtype):
    assert _run_ffn(monkeypatch, "noise", case, dtype).share["ffn_block"] <= 1.0


@pytest.mark.parametrize("fault", ["residual", "tile"])
@pytest.mark.parametrize("case", chip_smoke.FFN_CASES, ids=str)
def test_ffn_check_fails_a_planted_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_ffn(monkeypatch, fault, case, "bfloat16")


# The two normed codes that row 10's phase B moved on the card in a draw
# that failed the one-code allowance the check had before (H 4096, w8, one
# row, gelu_tanh, offset 0, layer 0).
PHASE_B_MOVED = (2464, 3159)


def _moved_codes_ffn(positions, report=True):
    """A stand-in kernel whose phase B multiplies the plain prologue's codes
    with those at ``positions`` (of row 0) moved by one quantum, as an ulp
    in the norm statistics moves a code at a rounding boundary; with
    ``report`` its scratch holds those codes (as the card's workspace
    does), else the plain ones."""
    def ffn(attn, x, wo_q, wo_s, norm_w, w13_q, w13_s, w2_q, w2_s, layer, *, bits, act,
            eps, offset=0.0, scratch=None):
        x2 = ffn_mod.wo_stage(attn, x, wo_q[layer], wo_s[layer], bits=bits)
        plain, sx = a8_mod.prologue(x2, norm_w[layer], eps, offset)
        codes = plain.clone()
        for i in positions:
            codes[0, i] += 1 if codes[0, i] < 127 else -1
        gate, up = ffn_mod._linear(codes, sx, w13_q[layer], w13_s[layer], bits).chunk(2, dim=-1)
        h = (ffn_mod.activation(gate, act) * up).to(x2.dtype)
        if scratch is not None:
            scratch.update(x2=x2, h=h, norm_codes=codes if report else plain)
        return ffn_mod.w2_stage(h, x2, w2_q[layer], w2_s[layer], bits=bits)[0]

    return ffn


def _run_moved(monkeypatch, positions, report=True, rows=2):
    monkeypatch.setattr(ffn_mod, "ffn_block_stacked", _moved_codes_ffn(positions, report))
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_ffn_block(sm, 4096, 512, rows, [(8, "gelu_tanh", 0.0, 0)],
                               torch.Generator().manual_seed(17), CPU, torch.bfloat16)
    return sm


def test_ffn_check_bounds_phase_b_by_the_codes_that_moved(monkeypatch, capsys):
    """The card's two moved codes, 2464 and 3159, replayed at H 4096 (F cut to
    512 here): reported as the card's workspace reports them, phase B passes
    and the count is printed."""
    sm = _run_moved(monkeypatch, PHASE_B_MOVED)
    assert sm.share["ffn_block"] <= 1.0
    assert "case by case: [2]" in capsys.readouterr().out


def test_ffn_check_fails_codes_moved_unreported(monkeypatch):
    """The same two moves with the plain codes reported: nothing bounds them,
    and phase B fails (the bound is not slack)."""
    with pytest.raises(AssertionError, match=r"phase B \(h\).*beyond the limit"):
        _run_moved(monkeypatch, PHASE_B_MOVED, report=False)


def test_ffn_check_fails_too_many_moved_codes(monkeypatch):
    """More than FFN_MOVED_CODES moved codes in a row fail, bound or not."""
    many = range(1000, 1000 + chip_smoke.FFN_MOVED_CODES + 1)
    with pytest.raises(AssertionError, match="norm codes moved"):
        _run_moved(monkeypatch, many)


def test_ffn_check_reads_one_row_codes_from_a_two_row_call(monkeypatch):
    """At one row the kernel keeps its codes in shared memory: the check
    calls it at 2 rows on [x2; x2] with attn zero, whose workspace holds
    them (the stand-in moves row 0's codes in both calls)."""
    calls = []
    moved = _moved_codes_ffn(PHASE_B_MOVED)

    def ffn(attn, x, *args, scratch=None, **kw):
        calls.append(x.shape[0])
        out = moved(attn, x, *args, scratch=scratch, **kw)
        if x.shape[0] == 1:
            del scratch["norm_codes"]  # one row: no workspace
        return out

    monkeypatch.setattr(ffn_mod, "ffn_block_stacked", ffn)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_ffn_block(sm, 4096, 512, 1, [(8, "gelu_tanh", 0.0, 0)],
                               torch.Generator().manual_seed(17), CPU, torch.bfloat16)
    assert calls == [1, 2] and sm.share["ffn_block"] <= 1.0


def _run_ffn_ring(monkeypatch, fault, case, rows=3):
    """check_ffn_block with the kernel replaced by its schedule's emulation
    (``torch_port_util.ffn_block_emulate``: codes once a row a phase, each
    block's walk of its ring, the tensor-core tile), one planted fault."""
    def ffn(*args, **kw):
        return ffn_block_emulate(*args, **kw, fault=fault)

    monkeypatch.setattr(ffn_mod, "ffn_block_stacked", ffn)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_ffn_block(sm, 384, 1024, rows, [case], torch.Generator().manual_seed(1),
                               CPU, torch.bfloat16)
    return sm


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("case", chip_smoke.FFN_CASES, ids=str)
def test_ffn_check_passes_the_ring_schedule(monkeypatch, case, rows):
    assert _run_ffn_ring(monkeypatch, None, case, rows).share["ffn_block"] <= 1.0


@pytest.mark.parametrize("fault", ["codes_from_b", "wrong_layer", "sx_neighbour",
                                   "early_reuse"])
@pytest.mark.parametrize("case", chip_smoke.FFN_CASES, ids=str)
def test_ffn_check_fails_a_ring_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_ffn_ring(monkeypatch, fault, case)


a8_mod = importlib.import_module("metalchat_tpu_torch.ops.a8_matvec")


def _run_a8(monkeypatch, fault, case, rows):
    """check_a8 with raw mode replaced by the tensor-core schedule's
    emulation (``torch_port_util.a8_mma_emulate``), one planted fault."""
    def raw(xq, p_stack, layer, *, bits):
        return a8_mma_emulate(xq, p_stack[layer], bits, fault=fault)

    monkeypatch.setattr(a8_mod, "quant_matvec_stacked", raw)
    sm = chip_smoke.Smoke(torch)
    chip_smoke.check_a8(sm, [case], rows, torch.Generator().manual_seed(1), CPU)
    return sm


@pytest.mark.parametrize("rows", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("case", chip_smoke.A8_FIXTURE, ids=str)
def test_a8_check_passes_the_mma_schedule(monkeypatch, case, rows):
    _run_a8(monkeypatch, None, case, rows)


# no_corr: int4 only; pad_leak: row counts that leave padded code columns
# (5 in one n-tile, 9 in two).
A8_INT4 = [c for c in chip_smoke.A8_FIXTURE if c[3] == 4]


@pytest.mark.parametrize("fault,case,rows", [
    *(("drop_step", c, r) for c in chip_smoke.A8_FIXTURE for r in (1, 5)),
    *(("no_corr", c, 5) for c in A8_INT4),
    *(("pad_leak", c, r) for c in chip_smoke.A8_FIXTURE for r in (5, 9))], ids=str)
def test_a8_check_fails_a_planted_fault(monkeypatch, fault, case, rows):
    with pytest.raises(AssertionError, match="not bit-exact"):
        _run_a8(monkeypatch, fault, case, rows)


# -- mixtral-fixture's routing check (a router near tie that flips) -------------

def _tiny_moe():
    from metalchat_tpu_torch.config import MixtralConfig
    from metalchat_tpu_torch.models.transformer import init_random_params

    cfg = MixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=64,
                        tie_word_embeddings=False, num_experts=4, num_experts_per_tok=2)
    params = init_random_params(cfg, seed=3, dtype=torch.float32, device=CPU)
    # Routers whose K-th and (K+1)-th choices carry weight, and experts that
    # move the logits: a flip at a near tie then shows.
    params["layers"]["router"] = params["layers"]["router"] * 3
    for name in ("w1", "w3", "w2"):
        params["layers"][name] = params["layers"][name] * 10
    prompt = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(5))
    return cfg, params, prompt


def _cpu_run(cfg, params, prompt, steps: int = 4):
    with chip_smoke.recorded_routing(torch, []) as cpu_calls:
        ids, want = chip_smoke.greedy_logits(params, cfg, prompt, steps)
    assert len(cpu_calls) == steps * cfg.num_layers
    return ids, want, cpu_calls


def _flip(cpu_calls, call: int, near: bool):
    """Routing ``call``'s expert ids with its first token's K-th choice
    (``near``: a near tie on this draw, CPU gap 0.0025) or its first choice
    (not a tie) swapped for the CPU's (K+1)-th."""
    idx, probs = cpu_calls[call]
    idx, order = idx.clone(), probs[0].argsort(descending=True).tolist()
    k = idx.shape[1]
    out = order[k - 1] if near else order[0]
    idx[0] = torch.where(idx[0] == out, torch.tensor(order[k]), idx[0])
    return idx


def _card_run(cfg, params, prompt, ids, call: int, idx):
    """A stand-in for the card: the teacher-forced run with routing ``call``
    taking the expert ids ``idx``."""
    with chip_smoke.recorded_routing(torch, [], {call: idx}) as card_calls:
        got = chip_smoke.teacher_forced_logits(params, cfg, prompt, ids)
    return got, card_calls


def test_routed_logits_check_names_a_flip_and_passes(capsys):
    """A token routed to its (K+1)-th expert in place of its K-th on one side
    (decode step 2, layer 0, a near tie): the plain logit check fails
    there, the routing check names that step, layer and token with its
    router gap and passes, holding the step to the CPU run given that
    routing."""
    cfg, params, prompt = _tiny_moe()
    with torch.no_grad():
        ids, want, cpu_calls = _cpu_run(cfg, params, prompt)
        call = 2 * cfg.num_layers
        got, card_calls = _card_run(cfg, params, prompt, ids, call, _flip(cpu_calls, call, True))
        sm = chip_smoke.Smoke(torch)
        with pytest.raises(AssertionError, match="beyond the limit"):
            chip_smoke.check_logits(sm, "plain", got, want)
        share, flips, held = chip_smoke.check_routed_logits(
            sm, "routed", cfg, params, prompt, ids, want, cpu_calls, got, card_calls)
    assert share <= 1.0
    assert [(f["step"], f["layer"], f["row"]) for f in flips] == [(2, 0, 0)]
    assert 0 <= flips[0]["gap"] <= chip_smoke.ROUTER_TIE_GAP
    assert torch.equal(held[:2], want[:2]) and not torch.equal(held[2], want[2])
    assert "routed: step 2 layer 0 token 0: the card routed to experts" in capsys.readouterr().out
    out = held.argmax(-1).T  # the card's greedy ids from its own logits
    assert chip_smoke.check_routed_ids(sm, "ids", out, ids, flips, held) in (
        "identical", "parted at step 2, after the routing flip at step 2",
        "parted at step 3, after the routing flip at step 2")


def test_routed_logits_check_fails_a_wrong_expert_output():
    """The same flip with the card's expert outputs wrong: in the last layer
    (no routing reads its output, so the card routes as before), an expert
    that the card takes for that step's token has its w2 scaled by 1.5.
    The routing check still fails, at the logit limit."""
    cfg, params, prompt = _tiny_moe()
    with torch.no_grad():
        ids, want, cpu_calls = _cpu_run(cfg, params, prompt)
        call = 2 * cfg.num_layers
        idx = _flip(cpu_calls, call, True)
        _, card_calls = _card_run(cfg, params, prompt, ids, call, idx)
        last = cfg.num_layers - 1
        expert = int(card_calls[call + last][0][0, 0])
        wrong = {**params, "layers": dict(params["layers"])}
        w2 = wrong["layers"]["w2"].clone()
        w2[last, expert] *= 1.5
        wrong["layers"]["w2"] = w2
        got, wrong_calls = _card_run(cfg, wrong, prompt, ids, call, idx)
        assert all(torch.equal(a[0], b[0]) for a, b in zip(card_calls, wrong_calls))
        with pytest.raises(AssertionError, match="beyond the limit"):
            chip_smoke.check_routed_logits(chip_smoke.Smoke(torch), "routed", cfg, params,
                                           prompt, ids, want, cpu_calls, got, wrong_calls)


def test_routed_logits_check_fails_a_flip_at_a_large_gap():
    """A token whose first choice the card dropped for the CPU's (K+1)-th:
    its CPU router gap is above ROUTER_TIE_GAP, no drift between the card's
    and the CPU's router explains it, and the routing check fails, although
    the logits agree with the CPU given that routing."""
    cfg, params, prompt = _tiny_moe()
    with torch.no_grad():
        ids, want, cpu_calls = _cpu_run(cfg, params, prompt)
        call = 2 * cfg.num_layers
        got, card_calls = _card_run(cfg, params, prompt, ids, call,
                                    _flip(cpu_calls, call, False))
        flip = chip_smoke.routing_flips(cpu_calls, card_calls, cfg.num_layers)[0]
        assert flip["call"] == call and flip["gap"] > chip_smoke.ROUTER_TIE_GAP
        with pytest.raises(AssertionError, match="not a near tie"):
            chip_smoke.check_routed_logits(chip_smoke.Smoke(torch), "routed", cfg, params,
                                           prompt, ids, want, cpu_calls, got, card_calls)
