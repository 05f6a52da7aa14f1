"""Weight-only group quantization in the port (quant/quantize.py,
models/fuse.py, ops/quant_matmul.py) against the JAX package, on the CPU.

Tolerances (the storage orientation of quantized and fused leaves,
`with_orientation`, `auto_orient` and `requantize_per_channel` are held,
byte for byte, in tests/test_torch_quant.py):

* the dequant-matmul plain version against the TPU kernel
  (``quant_matmul_pallas``, interpret mode) on bf16 inputs: within one bf16
  step of each value plus one bf16 step of the largest output. Both cast
  the weight to bf16; the plain version sums exact products in f32 and
  rounds once, while the interpreted kernel's bf16 dot on the CPU lands up
  to about 2**-9 of the largest output away from the exact sum;
* against the XLA formulation (``quant_matmul``) in f32: 1e-5 relative
  (plus 1e-5 of the largest output, for sums that cancel), the summation
  order being the only difference;
* the trained fixture end to end in f32: prefill logits over a dense f32
  cache within 1e-4 (nothing is quantized at run time there); greedy tokens
  through `generate` with int8 KV identical.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.ops.quant_matmul_pallas import quant_matmul_pallas
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.ops import quant_matmul as tqm
from metalchat_tpu_torch.quant import quantize as tq
from torch_port_util import jax_tree_to_numpy

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

# The JAX package's quant/__init__ exports a function named `quantize`,
# which shadows the module as an attribute.
jq = importlib.import_module("metalchat_tpu.quant.quantize")

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
def _leaf(rng, in_f, out_f, bits, group_size, transposed, stacked=False):
    w = (rng.standard_normal(((2,) if stacked else ()) + (in_f, out_f)) * 0.05).astype(
        np.float32)
    return (jq.quantize(w, bits=bits, group_size=group_size, transposed=transposed),
            tq.quantize(w, bits=bits, group_size=group_size, transposed=transposed,
                        device="cpu"))


def _bf16_values(a):
    """f32 values that bf16 represents exactly."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("rows", [1, 8])
def test_dequant_matmul_plain_matches_pallas_kernel(bits, rows):
    """The plain version in bf16 against the TPU kernel (interpret mode) on
    the same bf16-representable x (tolerance: module docstring)."""
    rng = np.random.default_rng(3)
    in_f, out_f = 512, 256
    jt, tt = _leaf(rng, in_f, out_f, bits, 32, False)
    x = _bf16_values(rng.standard_normal((rows, in_f)).astype(np.float32))
    want = np.asarray(quant_matmul_pallas(jnp.asarray(x), jt.q, jt.scales, bits=bits,
                                          group_size=32, block_out=128, block_in=256,
                                          interpret=True))
    got = tqm.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16), tt.q, tt.scales,
                             bits=bits, group_size=32, transposed=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [32, None], ids=["g32", "per-channel"])
@pytest.mark.parametrize("transposed", [False, True])
def test_dequant_matmul_plain_matches_xla(bits, group_size, transposed):
    """The plain version and `quant_matmul` in f32 against the JAX
    package's `quant_matmul` / `_quant_matmul_transposed`, 1e-5 relative."""
    rng = np.random.default_rng(4)
    jt, tt = _leaf(rng, 256, 192, bits, group_size, transposed)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), jt))
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tqm.dequant_matmul_plain(
        xt, tt.q, tt.scales, bits=bits, group_size=tt.group_size, transposed=transposed
    ).numpy(), want, **tol)
    np.testing.assert_allclose(tq.quant_matmul(xt, tt).numpy(), want, **tol)


@pytest.mark.parametrize("rows", [32, 33])
@pytest.mark.parametrize("transposed", [False, True])
def test_linear_routes_by_rows(monkeypatch, rows, transposed):
    """Up to 32 rows (leading dims flattened) take the dequant-matmul
    kernel's wrapper, more the plain formulation; both match JAX `linear`."""
    rng = np.random.default_rng(5)
    jt, tt = _leaf(rng, 128, 96, 4, 32, transposed)
    x = rng.standard_normal((rows // 8 if rows == 32 else rows, 8 if rows == 32 else 1, 128))
    x = x.astype(np.float32)
    want = np.asarray(jq.linear(jnp.asarray(x), jt))
    calls = []
    orig = tq.dequant_matmul
    monkeypatch.setattr(tq, "dequant_matmul", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    got = tq.linear(torch.from_numpy(x), tt)
    assert got.shape == want.shape
    assert len(calls) == (1 if rows <= 32 else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("transposed", [False, True])
def test_dequant_matmul_f32_output(transposed):
    """``out_dtype=torch.float32`` (a row-parallel partial): the same f32
    sums over the weight in x's dtype, not rounded; rounded to x's dtype
    they are the default output bit for bit. Another dtype is refused."""
    rng = np.random.default_rng(9)
    _, tt = _leaf(rng, 128, 96, 4, 32, transposed)
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(bits=4, group_size=32, transposed=transposed)
    got = tqm.dequant_matmul(x, tt.q, tt.scales, out_dtype=torch.float32, **kw)
    w = tqm.dequant_weight(tt.q, tt.scales, dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float() @ w.float())
    assert torch.equal(got.to(torch.bfloat16), tqm.dequant_matmul(x, tt.q, tt.scales, **kw))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="out_dtype"):
        tqm.dequant_matmul(torch.empty(8, 128, dtype=torch.bfloat16, **meta),
                           torch.empty(96, 64, dtype=torch.int8, **meta),
                           torch.empty(96, 4, dtype=torch.bfloat16, **meta), bits=4,
                           group_size=32, transposed=True, out_dtype=torch.float16)


@pytest.mark.parametrize("bad", ["rows", "in", "group", "scales"])
def test_dequant_matmul_gate(bad):
    """What the kernel does not take raises before any launch (meta tensors
    stand in for the card's: the gate runs before the build)."""
    meta = dict(device="meta")
    rows, in_f, group = 4, 128, 32
    if bad == "rows":
        rows = 33
    if bad == "in":
        in_f, group = 112, 16
    if bad == "group":
        group = 8
    x = torch.empty(rows, in_f, dtype=torch.bfloat16, **meta)
    q = torch.empty(96, in_f // 2, dtype=torch.int8, **meta)
    s = torch.empty(96, in_f // group + (bad == "scales"), **meta)
    assert not tqm.supported(rows, in_f, group) or bad == "scales"
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        tqm.dequant_matmul(x, q, s, bits=4, group_size=group, transposed=True)


@pytest.fixture(scope="module")
def jax_fixture():
    from metalchat_tpu.config import load_config as jload_config
    from metalchat_tpu.io.loaders import load_params as jload_params
    from metalchat_tpu.io.safetensors import open_safetensors as jopen

    cfg = jload_config(FIXTURE / "config.json")
    params = jload_params(jopen(FIXTURE), cfg, dtype=jnp.float32, max_seq_len=128)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    return cfg, params, tokens


@pytest.mark.parametrize("bits", [4, 8])
def test_fixture_weight_only_generate_matches_jax(jax_fixture, bits):
    """The trained fixture quantized weight-only (group 32, lm_head too),
    fused: 3 prompts of 24 tokens. Prefill logits over a dense f32 cache
    within 1e-4; through both packages' `generate` (int8 KV) 16 greedy
    tokens identical. The JAX side runs its XLA formulation (no variable
    set), the port's decode steps its kernel wrapper (the plain version on
    the CPU). (Over an int8 cache an ulp upstream can move one KV code, so
    logits are compared over a dense one.)"""
    from metalchat_tpu.engine import generate as jgenerate
    from metalchat_tpu.models.transformer import forward as jforward
    from metalchat_tpu.cache import KVCache as JKVCache
    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.transformer import forward

    jcfg, jparams, tokens = jax_fixture
    jp = jfuse(jq.quantize_params(jparams, bits=bits, group_size=32, quantize_lm_head=True),
               jcfg)
    prompts = tokens[200:200 + 3 * 24].reshape(3, 24)
    want_logits, _ = jforward(jp, JKVCache.create(jcfg, 3, 128, dtype=jnp.float32),
                              jnp.asarray(prompts), 0, jcfg)
    want = np.asarray(jgenerate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=16,
                                quantized_kv=True))

    cfg = load_config(FIXTURE / "config.json")
    params = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    assert params["layers"]["wqkv"].transposed and not params["layers"]["wo"].transposed
    tp = torch.from_numpy(prompts).long()
    logits, _ = forward(params, KVCache.create(cfg, 3, 128, dtype=torch.float32, device="cpu"),
                        tp, 0, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    got = generate(params, cfg, tp, max_new_tokens=16, quantized_kv=True)
    np.testing.assert_array_equal(got.numpy(), want)
