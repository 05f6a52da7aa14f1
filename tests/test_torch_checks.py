"""`chip_smoke.py`'s kernel checks can fail.

On the CPU each kernel wrapper is its plain version, so the checks compare
the plain version with itself. Here the wrapper is replaced by a faulty
one: the new row left out of the attention, a causal or window edge one
position off, or one position's v-scale wrong. Each must fail the check.
A wrapper that differs from the plain version only by f32 rounding noise
must pass. The shapes are the fixture's (hd=64).
"""

import importlib

import pytest
import torch

import chip_smoke
from metalchat_tpu_torch.ops.reference import MASK_VALUE

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


def _faulty_decode(fault):
    plain = decode_mod.decode_attention_update_plain

    def update(q, kn, vn, k, v, ks, vs, layer, lengths, *, scale, window=None):
        out, *cache = plain(q.float(), kn.float(), vn.float(), k, v, ks, vs, layer,
                            lengths, scale=scale, window=window)
        if fault == "noise":
            return _noisy(out, q.dtype), *cache
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


# v_scale: the wrong position lies inside the attended range only in the
# first two cases (the others attend a window or a zeroed cache there).
@pytest.mark.parametrize("fault,case", [
    *(("drop_new", c) for c in chip_smoke.DECODE_CASES_FIXTURE),
    *(("edge", c) for c in chip_smoke.DECODE_CASES_FIXTURE),
    *(("v_scale", c) for c in chip_smoke.DECODE_CASES_FIXTURE[:2])], ids=str)
def test_decode_check_fails_a_one_row_fault(monkeypatch, fault, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_decode(monkeypatch, fault, case)


def _faulty_flash(fault):
    plain = flash_mod.flash_attention_plain

    def flash(q, k, v, start, *, scale, window=None):
        if fault == "noise":
            out = plain(q.float(), k.float(), v.float(), start, scale=scale, window=window)
            return _noisy(out, q.dtype)
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
def test_flash_check_fails_an_edge_fault(monkeypatch, case):
    with pytest.raises(AssertionError, match="beyond the limit"):
        _run_flash(monkeypatch, "edge", case)
