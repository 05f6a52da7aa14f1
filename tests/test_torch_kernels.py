"""Plain PyTorch versions of the port's CUDA kernels vs the JAX
package's Pallas kernels (interpret mode), f32 on the CPU.

On the CPU every wrapper takes its kernel's plain version, so these tests
pin down the function each CUDA kernel must compute. Tolerances:

* a8_matvec raw mode: int32 bit-exact (integer arithmetic);
* a8_matvec fused, no norm: f32 output bit-exact (same act-quant op order,
  exact integer stage, same post-scale order);
* a8_matvec fused with the rmsnorm prologue: the f32 mean may reduce in
  another order (±1 ulp), which can move a borderline element by one int8
  quantum; at most one quantum, only where x/sx sits within 1e-3 of a
  rounding boundary, and rows whose codes agree give identical outputs;
* decode update: cache bytes and scales bit-exact, attention rtol = atol =
  1e-5 (online vs one-pass softmax, summation order);
* decode attention, read-only (f32 or int8 cache, stacked and one layer):
  rtol = atol = 1e-5 (same reasons);
* flash attention: rtol = atol = 1e-5 (same reasons).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.cache import quantize_kv as jquantize_kv
from metalchat_tpu.ops import xla as xops
from metalchat_tpu.ops.a8_matvec_pallas import (
    quant_matvec_stacked as j_raw,
    quant_matvec_stacked_fused as j_fused,
)
from metalchat_tpu.ops import decode_attention_pallas as jdecode
from metalchat_tpu.ops.decode_attention_pallas import (
    decode_attention_update_quantized_stacked as j_decode_update,
)
from metalchat_tpu.ops.flash_attention_pallas import flash_attention as j_flash
from metalchat_tpu_torch.ops import a8_matvec as tm
from metalchat_tpu_torch.ops import decode_attention as tdecode
from metalchat_tpu_torch.ops.decode_attention import (
    decode_attention_update_quantized_stacked,
)
from metalchat_tpu_torch.ops.flash_attention import flash_attention

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

IN_F, OUT_F, L = 256, 256, 2


def _weights(bits, seed):
    rng = np.random.default_rng(seed)
    k = IN_F // 2 if bits == 4 else IN_F
    p = rng.integers(-128, 128, (L, OUT_F, k), dtype=np.int8)
    s = (rng.random((L, 1, OUT_F), dtype=np.float32) * 0.1).astype(np.float32)
    return rng, p, s


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("batch", [1, 3])
def test_a8_matvec_raw_bit_exact(bits, batch):
    rng, p, _ = _weights(bits, 0)
    xq = rng.integers(-127, 128, (batch, IN_F), dtype=np.int8)
    want = [np.asarray(j_raw(jnp.asarray(xq), jnp.asarray(p), l, bits=bits,
                             block_out=128, interpret=True)) for l in range(L)]

    for l in range(L):
        got = tm.quant_matvec_stacked(torch.from_numpy(xq), torch.from_numpy(p), l,
                                      bits=bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[l])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scales_bf16", [False, True])
def test_a8_matvec_fused_no_norm(bits, scales_bf16):
    rng, p, s = _weights(bits, 1)
    x = rng.standard_normal((2, IN_F)).astype(np.float32)
    x[1] = 0.0  # sx = 1 branch
    js = jnp.asarray(s, jnp.bfloat16) if scales_bf16 else jnp.asarray(s)
    want = [np.asarray(j_fused(jnp.asarray(x), jnp.asarray(p), js, l, bits=bits,
                               block_out=128, interpret=True)) for l in range(L)]

    ts = torch.from_numpy(s)
    ts = ts.to(torch.bfloat16) if scales_bf16 else ts
    for l in range(L):
        got = tm.quant_matvec_stacked_fused(torch.from_numpy(x), torch.from_numpy(p),
                                            ts, l, bits=bits)
        np.testing.assert_allclose(got.numpy(), want[l], rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [4, 8])
def test_a8_matvec_fused_norm_prologue(bits):
    rng, p, s = _weights(bits, 2)
    x = rng.standard_normal((3, IN_F)).astype(np.float32)
    nw = rng.random((L, IN_F)).astype(np.float32)
    want_out, want_codes, want_ratio = [], [], []
    for l in range(L):
        want_out.append(np.asarray(j_fused(
            jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), l, bits=bits,
            block_out=128, interpret=True, norm_stack=jnp.asarray(nw)[:, None, :],
            norm_eps=1e-5)))
        # The kernel's prologue equals ops.rms_norm outside (JAX package test).
        h = xops.rms_norm(jnp.asarray(x), jnp.asarray(nw[l]), eps=1e-5)
        absmax = jnp.max(jnp.abs(h), axis=-1, keepdims=True)
        want_ratio.append(np.asarray(h / (absmax / 127.0)))
        want_codes.append(np.clip(np.round(want_ratio[-1]), -127, 127))

    for l in range(L):
        codes, _ = tm.prologue(torch.from_numpy(x), torch.from_numpy(nw[l]), 1e-5)
        diff = codes.numpy().astype(np.int32) - want_codes[l]
        assert np.abs(diff).max() <= 1
        frac = np.abs(np.abs(want_ratio[l] - np.trunc(want_ratio[l])) - 0.5)
        assert np.all(frac[diff != 0] < 1e-3), "a code moved off a rounding boundary"
        got = tm.quant_matvec_stacked_fused(
            torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(s), l,
            bits=bits, norm_stack=torch.from_numpy(nw), norm_eps=1e-5).numpy()
        same = np.all(diff == 0, axis=1)
        np.testing.assert_allclose(got[same], want_out[l][same], rtol=1e-6, atol=0)


def _decode_inputs(seed=0, L_=2, B=3, nkv=2, T=64, hd=32, nh=4):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (L_, B, nkv, T, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (L_, B, nkv, T, hd), dtype=np.int8)
    ks = (rng.random((L_, B, nkv, T)) * 0.01).astype(np.float32)
    vs = (rng.random((L_, B, nkv, T)) * 0.01).astype(np.float32)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kn = rng.standard_normal((B, nkv, hd)).astype(np.float32)
    vn = rng.standard_normal((B, nkv, hd)).astype(np.float32)
    kn[2, 1] = 0.0  # all-zero row: scale 0 → inv 0, codes 0
    return q, kn, vn, k, v, ks, vs


@pytest.mark.parametrize("window", [None, 9])
def test_decode_attention_update_matches(window):
    q, kn, vn, k, v, ks, vs = _decode_inputs()
    lengths = np.array([1, 16, 17], np.int32)  # length 1 and both sides of a block edge
    scale = 32 ** -0.5
    outs = j_decode_update(*(jnp.asarray(a) for a in (q, kn, vn, k, v, ks, vs)), 1,
                           jnp.asarray(lengths), scale=scale, window=window,
                           block_t=16, interpret=True)
    want = [np.asarray(o) for o in outs]

    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k, v, ks, vs))
    attn, k2, v2, ks2, vs2 = decode_attention_update_quantized_stacked(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
        tks, tvs, 1, torch.from_numpy(lengths), scale=scale, window=window)
    assert k2 is tk and ks2 is tks  # updated in place
    for got, w in zip((k2, v2, ks2, vs2), want[1:]):
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_allclose(attn.numpy(), want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 9])
def test_decode_attention_read_only_matches(quantized, window):
    """Read-only mode, stacked (layer 1) and on one layer, against the JAX
    kernels over the same cache: int8 with scales, or its f32 values."""
    q, _, _, k, v, ks, vs = _decode_inputs(seed=6)
    if not quantized:
        k, v = ((c * s[..., None]).astype(np.float32) for c, s in ((k, ks), (v, vs)))
    lengths = np.array([1, 16, 17], np.int32)
    scale = 32 ** -0.5
    j = [jnp.asarray(a) for a in (q, k, v, ks, vs, lengths)]
    kw = dict(scale=scale, window=window, block_t=16, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v, ks, vs, lengths)]
    tkw = dict(scale=scale, window=window)
    if quantized:
        want = jdecode.decode_attention_quantized_stacked(*j[:5], 1, j[5], **kw)
        want_one = jdecode.decode_attention_quantized(j[0], *(a[1] for a in j[1:5]), j[5],
                                                      **kw)
        got = tdecode.decode_attention_quantized_stacked(*t[:5], 1, t[5], **tkw)
        got_one = tdecode.decode_attention_quantized(t[0], *(a[1] for a in t[1:5]), t[5],
                                                     **tkw)
    else:
        want = jdecode.decode_attention_stacked(*j[:3], 1, j[5], **kw)
        want_one = jdecode.decode_attention(j[0], j[1][1], j[2][1], j[5], **kw)
        got = tdecode.decode_attention_stacked(*t[:3], 1, t[5], **tkw)
        got_one = tdecode.decode_attention(t[0], t[1][1], t[2][1], t[5], **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_one.numpy(), np.asarray(want_one), rtol=1e-5, atol=1e-5)


def test_quantize_kv_matches():
    _, kn, *_ = _decode_inputs(seed=4)
    want_q, want_s = (np.asarray(a) for a in jquantize_kv(jnp.asarray(kn)))

    from metalchat_tpu_torch.cache import quantize_kv

    got_q, got_s = quantize_kv(torch.from_numpy(kn))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("start,window", [(0, None), (8, None), ("rows", None), (0, 8)])
def test_flash_attention_matches(start, window):
    rng = np.random.default_rng(5)
    b, s, nh, nkv, t, hd = 2, 32, 4, 2, 64, 32
    q = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, nkv, t, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, t, hd)).astype(np.float32)
    start_pos = np.array([0, 16], np.int32) if start == "rows" else start
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(start_pos), scale=0.2, window=window,
                              block_q=16, block_k=16, interpret=True))

    tstart = torch.from_numpy(start_pos) if start == "rows" else start
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          tstart, scale=0.2, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _update_args(hd=64, bad=None):
    """Operands of the decode-update kernel on the meta device, one of them
    made wrong by `bad`."""
    L_, b, nh, nkv, t = 2, 2, 4, 2, 16
    if bad == "hd32":
        hd = 32
    meta = dict(device="meta")
    q = torch.empty(b, nh, hd, dtype=torch.bfloat16, **meta)
    kn = torch.empty(b, nkv, hd, dtype=torch.bfloat16, **meta)
    vn = torch.empty(b, nkv, hd - 8 if bad == "v_new" else hd, dtype=torch.bfloat16, **meta)
    k = torch.empty(L_, b, nkv, t, hd, dtype=torch.int8, **meta)
    v = torch.empty(L_, b, nkv, t // 2 if bad == "v" else t, hd, dtype=torch.int8, **meta)
    ks = torch.empty(L_, b, nkv, t, **meta)
    vs = torch.empty(L_, b, nkv, t - 1 if bad == "v_scale" else t, **meta)
    layer = L_ if bad == "layer" else 1
    lengths = torch.empty(b, dtype=torch.int32, **meta)
    return q, kn, vn, k, v, ks, vs, layer, lengths


def test_decode_update_kernel_gate_accepts():
    from metalchat_tpu_torch.ops.decode_attention import check_args

    check_args(*_update_args(hd=64))
    check_args(*_update_args(hd=128))


@pytest.mark.parametrize("bad", ["v", "v_scale", "v_new", "hd32", "layer"])
def test_decode_update_kernel_gate_rejects(bad):
    """The CUDA wrapper's checks run before the launch: the kernel indexes
    every cache tensor with k's strides and writes into them in place."""
    from metalchat_tpu_torch.ops.decode_attention import check_args

    with pytest.raises(ValueError, match="decode_attention_update"):
        check_args(*_update_args(bad=bad))


def _read_args(bad=None):
    """Operands of the read-only kernel on the meta device: an int8 cache
    with scales, a bf16 cache without (``bad="bf16"``: bf16 scales given),
    or one operand made wrong by ``bad``."""
    q, _, _, k, v, ks, vs, layer, lengths = _update_args(hd=128)
    if bad in ("bf16", "f32_cache", "bf16_ok"):
        k = torch.empty(k.shape, dtype=torch.float32 if bad == "f32_cache"
                        else torch.bfloat16, device="meta")
        v = torch.empty(v.shape, dtype=torch.bfloat16, device="meta")
        if bad != "bf16":
            ks = vs = None
    elif bad == "v_scale":
        vs = vs[..., :-1]
    elif bad == "layer":
        layer = 2
    return q, k, v, ks, vs, layer, lengths


def test_decode_read_kernel_gate():
    tdecode.check_read_args(*_read_args())
    tdecode.check_read_args(*_read_args("bf16_ok"))
    for bad in ("bf16", "f32_cache", "v_scale", "layer"):
        with pytest.raises(ValueError, match="decode_attention"):
            tdecode.check_read_args(*_read_args(bad))


@pytest.mark.parametrize("lengths", [[0, 5], [5, 65]])
def test_decode_update_lengths_outside_cache_raise(lengths):
    q, kn, vn, k, v, ks, vs = (torch.from_numpy(a) for a in _decode_inputs(T=64))
    with pytest.raises(ValueError, match=r"lengths must lie in \[1, 64\]"):
        decode_attention_update_quantized_stacked(
            q, kn, vn, k, v, ks, vs, 1, torch.tensor(lengths + [1], dtype=torch.int32),
            scale=0.2)


@pytest.mark.parametrize("lengths", [[0, 5], [5, 65]])
def test_decode_read_lengths_outside_cache_raise(lengths):
    q, _, _, k, v, ks, vs = (torch.from_numpy(a) for a in _decode_inputs(T=64))
    with pytest.raises(ValueError, match=r"lengths must lie in \[1, 64\]"):
        tdecode.decode_attention_quantized_stacked(
            q, k, v, ks, vs, 1, torch.tensor(lengths + [1], dtype=torch.int32), scale=0.2)
