"""Port quantization (metalchat_tpu_torch/quant/quantize.py, models/fuse.py)
vs the JAX package's quant/quantize.py and models/fuse.py, on the CPU.

Packed bytes and scales must be identical; the integer stages of the
W4A8/W8A8 linear are exact, so its f32 output must be too. Quantized and
fused leaves keep the JAX package's storage orientation for every scheme,
weight-only included.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu_torch.quant import quantize as tq
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

# The JAX package's quant/__init__ exports a function named `quantize`,
# which shadows the module as an attribute.
jq = importlib.import_module("metalchat_tpu.quant.quantize")


@pytest.mark.parametrize("bits,group_size,transposed,act_bits", [
    (4, None, True, 8), (8, None, True, 8), (4, 32, False, None), (8, 32, True, None),
])
def test_quantize_bytes_and_scales_identical(bits, group_size, transposed, act_bits):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 128, 96)) * 0.05).astype(np.float32)
    w[0, :, 3] = 0.0  # an all-zero channel: scale 0, codes 0
    jt = jq.quantize(w, bits=bits, group_size=group_size, transposed=transposed,
                     act_bits=act_bits)
    want_q, want_s = np.asarray(jt.q), np.asarray(jt.scales)

    tt = tq.quantize(w, bits=bits, group_size=group_size, transposed=transposed,
                     act_bits=act_bits, device="cpu")
    np.testing.assert_array_equal(tt.q.numpy(), want_q)
    np.testing.assert_array_equal(tt.scales.numpy(), want_s)
    assert (tt.in_features, tt.out_features) == (jt.in_features, jt.out_features)
    np.testing.assert_array_equal(tq._pack_int4(np.clip(
        np.round(w * 40), -8, 7).astype(np.int8)), jq._pack_int4(np.clip(
            np.round(w * 40), -8, 7).astype(np.int8)))


@pytest.mark.parametrize("bits", [4, 8])
def test_dequantize_matches(bits):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    want = np.asarray(jq.dequantize(jq.quantize(w, bits=bits, group_size=32), jnp.float32))
    got = tq.dequantize(tq.quantize(w, bits=bits, group_size=32, device="cpu"), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_act_quantize_bit_exact():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    x[1] = 0.0                        # absmax 0 → sx = 1
    x[2, :4] = [0.5, 1.5, -2.5, 2.5]  # exact .5 ties → round half to even
    x[2] *= 127.0 / np.abs(x[2]).max()
    xq, sx = jq._act_quantize(jnp.asarray(x))
    want_q, want_s = np.asarray(xq), np.asarray(sx)

    got_q, got_s = tq.act_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [3, 40, 200])
def test_matmul_a8_matches(bits, rows):
    """Both `_matmul_a8` forms (3-dot below 128 rows, 2-dot above) against
    the port's exact integer product: identical f32 outputs."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 192)) * 0.05).astype(np.float32)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    jt = jq.quantize(w, bits=bits, group_size=None, act_bits=8, transposed=True)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), jt))

    tt = tq.quantize(w, bits=bits, group_size=None, act_bits=8, transposed=True,
                     device="cpu")
    got = tq.linear(torch.from_numpy(x), tt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_fuse_projections_bytes_identical():
    from metalchat_tpu.config import LlamaConfig as JLlama
    from metalchat_tpu.models.fuse import fuse_projections as jfuse
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.convert import params_from_numpy
    from metalchat_tpu_torch.models.fuse import fuse_projections, split_fused

    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=96, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16)
    rng = np.random.default_rng(4)
    outs = {"wq": 64, "wk": 32, "wv": 32, "w1": 96, "w3": 96}
    unfused = {"layers": {
        n: jq.quantize((rng.standard_normal((2, 64, o)) * 0.05).astype(np.float32),
                       bits=4, group_size=None, act_bits=8, transposed=True,
                       scales_dtype=jnp.bfloat16)
        for n, o in outs.items()}}
    want = jax_tree_to_numpy(jfuse(unfused, JLlama(**kw))["layers"])
    tree = jax_tree_to_numpy(unfused)

    got = fuse_projections(params_from_numpy(tree, "cpu"), LlamaConfig(**kw))["layers"]
    assert set(got) == set(want) == {"wqkv", "w13"}
    for name in ("wqkv", "w13"):
        np.testing.assert_array_equal(got[name].q.numpy(), want[name]["q"])
        np.testing.assert_array_equal(got[name].scales.float().numpy(),
                                      want[name]["scales"].astype(np.float32))
        assert got[name].transposed and want[name]["transposed"]
    q, k, v = split_fused(torch.arange(64 + 32 + 32), (64, 32, 32))
    assert (q[-1], k[0], v[-1]) == (63, 64, 127)


DIMS = dict(vocab_size=64, hidden_size=128, intermediate_size=192, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=32)


def _dense_tree(seed=0):
    rng = np.random.default_rng(seed)
    h, f = DIMS["hidden_size"], DIMS["intermediate_size"]
    outs = {"wq": (h, 128), "wk": (h, 64), "wv": (h, 64), "wo": (128, h), "w1": (h, f),
            "w3": (h, f), "w2": (f, h)}
    layers = {n: (rng.standard_normal((2, i, o)) * 0.05).astype(np.float32)
              for n, (i, o) in outs.items()}
    return {"layers": layers,
            "lm_head": (rng.standard_normal((h, DIMS["vocab_size"])) * 0.05).astype(np.float32)}


def _same_leaf(got, want, name):
    """A port leaf against a `jax_tree_to_numpy` leaf: the same orientation,
    scheme, packed bytes and scales."""
    assert isinstance(got, tq.QuantizedTensor), name
    assert got.transposed == want["transposed"], name
    assert (got.bits, got.group_size, got.act_bits) == (
        want["bits"], want["group_size"], want["act_bits"]), name
    np.testing.assert_array_equal(got.q.numpy(), want["q"], err_msg=name)
    np.testing.assert_array_equal(got.scales.float().numpy(),
                                  want["scales"].astype(np.float32), err_msg=name)


QUANT_SCHEMES = [(4, 32, None), (8, 32, None), (4, None, None), (8, None, None),
                 (4, None, 8), (8, None, 8)]


@pytest.mark.parametrize("bits,group_size,act_bits", QUANT_SCHEMES, ids=str)
def test_quantize_and_fuse_match_jax(bits, group_size, act_bits):
    """Every unfused leaf (`quantize_params`) and every fused one
    (`fuse_projections`) has the JAX package's orientation, bytes and
    scales: weight-only fused leaves wider than their parts are stored
    transposed, as `auto_orient` stores them."""
    dense = _dense_tree()
    kw = dict(bits=bits, group_size=group_size, act_bits=act_bits, quantize_lm_head=True)
    from metalchat_tpu.config import LlamaConfig as JLlama
    from metalchat_tpu.models.fuse import fuse_projections as jfuse
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.convert import params_from_numpy
    from metalchat_tpu_torch.models.fuse import fuse_projections

    jtree = jq.quantize_params({n: jnp.asarray(v) if n == "lm_head" else
                                {k: jnp.asarray(w) for k, w in v.items()}
                                for n, v in dense.items()}, **kw)
    want = jax_tree_to_numpy(jtree)
    want_fused = jax_tree_to_numpy(jfuse(jtree, JLlama(**DIMS)))

    got = tq.quantize_params(params_from_numpy(dense, "cpu"), **kw)
    for name, leaf in want["layers"].items():
        _same_leaf(got["layers"][name], leaf, name)
    _same_leaf(got["lm_head"], want["lm_head"], "lm_head")
    got_fused = fuse_projections(got, LlamaConfig(**DIMS))
    assert set(got_fused["layers"]) == set(want_fused["layers"]) == {"wqkv", "wo", "w13", "w2"}
    for name, leaf in want_fused["layers"].items():
        _same_leaf(got_fused["layers"][name], leaf, name)


@pytest.mark.parametrize("bits,group_size", [(4, 32), (8, 32), (8, None)], ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_orientation_utilities_match(bits, group_size, transposed):
    """`with_orientation` and `auto_orient`: the JAX package's bytes."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((2, 64, 96)) * 0.05).astype(np.float32)
    jt = jq.quantize(w, bits=bits, group_size=group_size, transposed=transposed)
    tt = tq.quantize(w, bits=bits, group_size=group_size, transposed=transposed,
                     device="cpu")
    for target in (False, True):
        want = jax_tree_to_numpy(jq.with_orientation(jt, target))
        _same_leaf(tq.with_orientation(tt, target), want, f"to {target}")
    _same_leaf(tq.auto_orient(tt), jax_tree_to_numpy(jq.auto_orient(jt)), "auto")


@pytest.mark.parametrize("bits,act_bits", [(8, 8), (4, 8), (8, None)], ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_requantize_per_channel_matches(bits, act_bits, transposed):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    jt = jq.quantize(w, bits=4, group_size=32, transposed=transposed)
    tt = tq.quantize(w, bits=4, group_size=32, transposed=transposed, device="cpu")
    want = jax_tree_to_numpy(jq.requantize_per_channel(jt, bits=bits, act_bits=act_bits))
    _same_leaf(tq.requantize_per_channel(tt, bits=bits, act_bits=act_bits), want, "requant")


# -- clip_search, row-quantized embeddings ---------------------------------------

@pytest.mark.parametrize("bits,group_size,transposed,act_bits", [
    (4, None, True, 8), (8, None, True, 8), (4, 32, False, None), (8, 32, True, None),
    (4, 16, True, None), (8, None, False, None),
])
def test_clip_search_bytes_identical(bits, group_size, transposed, act_bits):
    """clip_search's 11-ratio grid gives the JAX package's codes and scales
    bit for bit (heavy-tailed weights, so that at int4 the search moves
    many scales), and through `quantize_params` too."""
    rng = np.random.default_rng(7)
    w = (rng.standard_t(3, (2, 128, 96)) * 0.02).astype(np.float32)
    w[0, :, 5] = 0.0  # an all-zero channel: every ratio's scale is 0
    kw = dict(bits=bits, group_size=group_size, transposed=transposed, act_bits=act_bits)
    jt = jq.quantize(w, clip_search=True, **kw)
    tt = tq.quantize(w, clip_search=True, device="cpu", **kw)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    if bits == 4:  # the search chose other ratios than 1.0
        plain = tq.quantize(w, device="cpu", **kw)
        assert (plain.scales != tt.scales).float().mean() > 0.3
    qkw = dict(bits=bits, group_size=group_size, act_bits=act_bits, quantize_lm_head=True,
               clip_search=True)
    want = jax_tree_to_numpy(jq.quantize_params(
        {"layers": {"wq": jnp.asarray(w)}, "lm_head": jnp.asarray(w[0])}, **qkw))
    got = tq.quantize_params({"layers": {"wq": torch.from_numpy(w)},
                              "lm_head": torch.from_numpy(w[0])}, **qkw)
    for leaf, ref in ((got["layers"]["wq"], want["layers"]["wq"]),
                      (got["lm_head"], want["lm_head"])):
        np.testing.assert_array_equal(leaf.q.numpy(), ref["q"])
        np.testing.assert_array_equal(leaf.scales.numpy(), ref["scales"])
        assert leaf.transposed == ref["transposed"]


@pytest.mark.parametrize("bits,group_size", [(8, 32), (4, 32), (8, None), (4, 16)], ids=str)
def test_quantize_embed_bytes_and_lookup_match_jax(bits, group_size):
    """`quantize_params(quantize_embed=True)`: the table row-quantized as the
    JAX package stores it (the same bytes, ``transposed=False``), and
    `lookup_embedding` of it equal to JAX's in f32, exactly."""
    rng = np.random.default_rng(8)
    embed = (rng.standard_normal((200, 64)) * 0.1).astype(np.float32)
    embed[3] = 0.0  # an all-zero row: scale 0
    kw = dict(bits=bits, group_size=group_size, quantize_embed=True)
    jt = jq.quantize_params({"layers": {}, "embed": jnp.asarray(embed)}, **kw)["embed"]
    tt = tq.quantize_params({"layers": {}, "embed": torch.from_numpy(embed)}, **kw)["embed"]
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    assert not tt.transposed and tt.bits == bits and tt.q.shape[0] == 200
    tokens = rng.integers(0, 200, (3, 7))
    tokens[0, 0] = 3
    want = np.asarray(jq.lookup_embedding(jnp.asarray(tokens), jt))
    got = tq.lookup_embedding(torch.from_numpy(tokens), tt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), embed[tokens], rtol=0,
                               atol=np.abs(embed).max() / (7 if bits == 4 else 127))
