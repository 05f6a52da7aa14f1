"""`LoraLinear` in the port (quant/quantize.py, models/transformer.py,
models/decode.py, models/fuse.py) against the JAX package, on the CPU.

A small Llama (hidden 64, 2 layers, 4 heads over 2 kv heads of 16, FFN
128) whose seven projections are all LoRA leaves, rank 4, scale 2.0, over
three bases: dense, int8 group 32 (weight-only) and W4A8 per-channel.
Parameters cross as numpy bytes; the JAX package runs its CPU paths (XLA).
Tolerances:

* dense and int8 g32 bases in f32: atol 1e-4 on logits and 1e-5 relative
  on a single `linear` (float rounding only, one op order);
* the W4A8 base: the integer stages are exact, but an f32 sum that the two
  packages round an ulp apart can move one int8 activation code by a
  quantum; logits within 2e-3 of the largest |logit| (as for the plain W4A8
  trees in tests/test_torch_gpt2.py).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.models import fuse as jfuse_mod
from metalchat_tpu.models.decode import decode_step as jdecode_step
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.quant.quantize import LoraLinear as JLoraLinear
from metalchat_tpu.quant.quantize import linear as jlinear
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.models import decode as tdecode
from metalchat_tpu_torch.models import fuse as tfuse
from metalchat_tpu_torch.models.transformer import forward, layer_leaf
from metalchat_tpu_torch.quant import LoraLinear
from metalchat_tpu_torch.quant.quantize import add_adaptor, linear
from test_model import TINY_LLAMA
from torch_port_util import jax_tree_to_numpy, port_config

torch.set_num_threads(1)

JSMALL = TINY_LLAMA.replace(hidden_size=64, intermediate_size=128, num_layers=2,
                            head_dim=16)
SMALL = port_config(JSMALL)
RANK = 4
LINEARS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
BASES = {"dense": None, "int8-g32": dict(bits=8, group_size=32),
         "w4a8": dict(bits=4, group_size=None, act_bits=8)}
F32_ATOL = 1e-4
A8_SHARE = 2e-3


def _jax_lora_tree(kind: str, seed: int = 3):
    params = jinit_random_params(JSMALL, seed=seed, dtype=jnp.float32)
    if BASES[kind] is not None:
        params = jquantize_params(params, **BASES[kind])
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in LINEARS:
        base = layers[name]
        in_f, out_f = (base.in_features, base.out_features) if hasattr(base, "q") \
            else base.shape[-2:]
        a = rng.standard_normal((SMALL.num_layers, in_f, RANK)).astype(np.float32) * 0.1
        b = rng.standard_normal((SMALL.num_layers, RANK, out_f)).astype(np.float32) * 0.1
        layers[name] = JLoraLinear(base=base, a=jnp.asarray(a), b=jnp.asarray(b), scale=2.0)
    return dict(params, layers=layers)


@pytest.fixture(scope="module", params=list(BASES))
def trees(request):
    jtree = _jax_lora_tree(request.param)
    return request.param, jtree, params_from_numpy(jax_tree_to_numpy(jtree), "cpu")


def _atol(kind, want):
    return A8_SHARE * np.abs(want).max() if kind == "w4a8" else F32_ATOL


def test_tree_crosses_as_lora(trees):
    _, _, params = trees
    for name in LINEARS:
        leaf = params["layers"][name]
        assert isinstance(leaf, LoraLinear) and leaf.scale == 2.0
        one = layer_leaf(leaf, 1)
        assert isinstance(one, LoraLinear) and one.a.shape == leaf.a.shape[1:]
        assert type(one.base) is type(leaf.base)


@pytest.mark.parametrize("rows", [3, 40])
def test_linear_matches_jax(trees, rows):
    """One layer's LoRA leaf through `linear` at 3 rows (row 11's plain
    version for a weight-only base) and at 40 (the dequantized product)."""
    kind, jtree, params = trees
    x = np.random.default_rng(rows).standard_normal((rows, SMALL.hidden_size)).astype(np.float32)
    for name in ("wq", "w1"):
        jleaf = jtree["layers"][name]
        jone = JLoraLinear(base=_jax_layer(jleaf.base, 0), a=jleaf.a[0], b=jleaf.b[0],
                           scale=jleaf.scale)
        want = np.asarray(jlinear(jnp.asarray(x), jone))
        got = linear(torch.from_numpy(x), layer_leaf(params["layers"][name], 0)).numpy()
        tol = _atol(kind, want) if kind == "w4a8" else 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _jax_layer(base, l):
    if hasattr(base, "q"):
        return dataclasses.replace(base, q=base.q[l], scales=base.scales[l])
    return base[l]


def test_forward_and_decode_step_match_jax(trees):
    """A 9-token prefill (the layer route), then `decode_step` at one token
    and at a 3-token window, logits against JAX's at each step."""
    kind, jtree, params = trees
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, SMALL.vocab_size, (2, 9))
    jc = JKVCache.create(JSMALL, 2, 32, dtype=jnp.float32)
    tc = KVCache.create(SMALL, 2, 32, dtype=torch.float32, device="cpu")
    want, jc = jforward(jtree, jc, jnp.asarray(prompt, jnp.int32), 0, JSMALL)
    got, tc = forward(params, tc, torch.from_numpy(prompt), 0, SMALL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_atol(kind, want))
    pos = 9
    for s in (1, 3):
        win = rng.integers(0, SMALL.vocab_size, (2, s))
        want, jc = jdecode_step(jtree, jc, jnp.asarray(win, jnp.int32), jnp.asarray(pos),
                                JSMALL)
        got, tc = tdecode.decode_step(params, tc, torch.from_numpy(win), torch.tensor(pos),
                                      SMALL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=_atol(kind, want))
        pos += s


def test_adaptors_move_the_logits(trees):
    """Premise: zeroing one projection's B moves the logits far beyond the
    tolerance, so a dropped adaptor would fail the comparisons above."""
    kind, _, params = trees
    tokens = torch.tensor([[5, 9, 23, 42, 7]])

    def logits(p):
        cache = KVCache.create(SMALL, 1, 16, dtype=torch.float32, device="cpu")
        return forward(p, cache, tokens, 0, SMALL)[0].numpy()

    base = logits(params)
    for name in LINEARS:
        leaf = params["layers"][name]
        cut = LoraLinear(base=leaf.base, a=leaf.a, b=torch.zeros_like(leaf.b), scale=leaf.scale)
        moved = logits(dict(params, layers=dict(params["layers"], **{name: cut})))
        assert np.abs(moved - base).max() > 20 * _atol(kind, base), name


def test_lora_never_takes_the_prologue_or_merged_block(trees):
    """A LoRA leaf is not a matvec-kernel leaf (its projections read one
    normed activation), the merged FFN block's gate refuses the tree, and
    `forward` still takes `decode_step` (the JAX rule)."""
    kind, _, params = trees
    layers = params["layers"]
    for name in LINEARS:
        assert not tdecode._kernel_ok(layers[name], 1)
    if kind == "w4a8":
        assert tdecode._kernel_ok(layers["wq"].base, 1)
    assert not tdecode._ffn_block_ok(layers, 1, torch.float32, SMALL)
    cache = KVCache.create(SMALL, 1, 16, dtype=torch.float32, device="cpu")
    assert tdecode.supports_fast_decode(params, cache, SMALL, torch.zeros(1, 1))


def test_fuse_projections_raises(trees):
    """The port's fuse refuses a LoRA group with the JAX `_concat_linears`
    message (JAX's `fuse_projections` catches it and leaves the group
    unfused; the port's raises, as it does on a dense/quantized mix)."""
    _, jtree, params = trees
    with pytest.raises(ValueError, match="cannot fuse LoRA-adapted projections"):
        jfuse_mod._concat_linears([jtree["layers"][n] for n in ("wq", "wk", "wv")])
    with pytest.raises(ValueError, match="cannot fuse LoRA-adapted projections"):
        tfuse._concat_linears([params["layers"][n] for n in ("wq", "wk", "wv")])
    with pytest.raises(ValueError, match="cannot fuse LoRA-adapted projections"):
        tfuse.fuse_projections(params, SMALL)
    mixed = dict(params["layers"], wq=params["layers"]["wq"].base)
    with pytest.raises(ValueError, match="cannot fuse LoRA-adapted projections"):
        tfuse.fuse_projections(dict(params, layers=mixed), SMALL)


def test_bf16_epilogue_rounds_as_jax():
    """In bf16 the epilogue after the two products is the scale rounded to
    bf16, one rounded product and one rounded sum: checked against those
    steps written out, with a scale bf16 cannot hold (0.3)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g).to(torch.bfloat16)
    y = torch.randn(3, 48, generator=g).to(torch.bfloat16)
    a = (torch.randn(64, 4, generator=g) * 0.1).to(torch.bfloat16)
    b = (torch.randn(4, 48, generator=g) * 0.1).to(torch.bfloat16)
    adapt = (x @ a) @ b
    s = torch.tensor(0.3, dtype=torch.bfloat16).float()
    want = (y.float() + (adapt.float() * s).to(torch.bfloat16).float()).to(torch.bfloat16)
    got = add_adaptor(x, y, a, b, 0.3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # JAX promotes a bf16 activation against f32 adaptors; so does the port.
    assert add_adaptor(x, y, a.float(), b.float(), 2.0).dtype == torch.float32
