"""Quantized checkpoints in the port (metalchat_tpu_torch/quant/checkpoint.py)
against the JAX package's quant/checkpoint.py, on the CPU.

Trees: the tiny Llama of tests/test_model.py (untied head) quantized W4A8
per channel, int4 group 8 with the head and a row-quantized embedding, and
int8 group 8 under LoRA adaptors; the tiny Gemma-3 (its norm names) W8A8.
Exact throughout:

* `export_quantized`: the same tensor names in the same order, each of the
  same dtype, shape and bytes, and the same metadata;
* files written by either package load in the other with equal leaves, and
  the f32 logits of the loaded trees agree to float rounding (atol 1e-5);
* the reference QLoRA dialect (built as tests/test_quant_checkpoint.py
  builds it, with and without ``output.weight``): both loaders give equal
  leaves, and 8 greedy ids and each step's logits (within 1e-5 of the
  largest |logit|: the random int8 weights give logits up to about 10)
  agree.
"""


import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.io.safetensors import SafetensorsDocument as JDocument
from metalchat_tpu.io.safetensors import save_safetensors as jsave
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.quant import checkpoint as jck
from metalchat_tpu.quant.quantize import LoraLinear as JLoraLinear
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.quant import LoraLinear, QuantizedTensor
from metalchat_tpu_torch.quant import checkpoint as tck
from test_model import TINY_GEMMA, TINY_LLAMA
from torch_port_util import jax_tree_to_numpy, port_config

torch.set_num_threads(1)

ATOL = 1e-5
JLLAMA = TINY_LLAMA.replace(tie_word_embeddings=False)


def _lora(params, rng, rank=3):
    layers = dict(params["layers"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        base = layers[name]
        L = base.q.shape[0]
        a = rng.standard_normal((L, base.in_features, rank)).astype(np.float32) * 0.1
        b = rng.standard_normal((L, rank, base.out_features)).astype(np.float32) * 0.1
        layers[name] = JLoraLinear(base=base, a=jnp.asarray(a), b=jnp.asarray(b), scale=2.0)
    return dict(params, layers=layers)


TREES = {
    "w4a8": (JLLAMA, dict(bits=4, group_size=None, act_bits=8)),
    "int4-g8-head-embed": (JLLAMA, dict(bits=4, group_size=8, quantize_lm_head=True,
                                        quantize_embed=True)),
    "int8-g8-lora": (JLLAMA, dict(bits=8, group_size=8)),
    "gemma-w8a8": (TINY_GEMMA, dict(bits=8, group_size=None, act_bits=8)),
}


@pytest.fixture(scope="module", params=list(TREES))
def tree(request):
    jcfg, quant = TREES[request.param]
    jparams = jquantize_params(jinit_random_params(jcfg, seed=11, dtype=jnp.float32), **quant)
    if request.param.endswith("lora"):
        jparams = _lora(jparams, np.random.default_rng(11))
    params = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    return request.param, jcfg, port_config(jcfg), jparams, params


def _np_bytes(a):
    a = np.ascontiguousarray(np.asarray(a))
    dtype = "bf16" if a.dtype.name == "bfloat16" else a.dtype.str
    return dtype, tuple(a.shape), a.view(np.uint8).tobytes()


def _torch_bytes(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return "bf16", tuple(t.shape), t.view(torch.int16).numpy().view(np.uint8).tobytes()
    a = t.numpy()
    return a.dtype.str, tuple(a.shape), a.view(np.uint8).tobytes()


def assert_tree_equal(got, want, path="params"):
    """A port tree against `jax_tree_to_numpy` of a JAX one: the same keys,
    leaf kinds, metadata and bytes (the rope tables, which each package
    computes with its own cos/sin, within 1e-6)."""
    if isinstance(got, LoraLinear):
        assert set(want) == {"base", "a", "b", "scale"}, path
        assert got.scale == want["scale"], path
        assert_tree_equal(got.base, want["base"], path + ".base")
        assert_tree_equal(got.a, want["a"], path + ".a")
        assert_tree_equal(got.b, want["b"], path + ".b")
    elif isinstance(got, QuantizedTensor):
        assert (got.bits, got.group_size, got.transposed, got.act_bits) == (
            want["bits"], want["group_size"], want["transposed"], want["act_bits"]), path
        assert_tree_equal(got.q, want["q"], path + ".q")
        assert_tree_equal(got.scales, want["scales"], path + ".scales")
    elif isinstance(got, dict):
        assert list(got) == list(want), path
        for k in got:
            if k == "rope":
                for t in got[k]:
                    np.testing.assert_allclose(got[k][t].numpy(), want[k][t], atol=1e-6)
                continue
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert _torch_bytes(got) == _np_bytes(want), path


def _logits(jparams, params, jcfg, cfg, tokens):
    want, _ = jforward(jparams, JKVCache.create(jcfg, 1, 32, dtype=jnp.float32),
                       jnp.asarray(tokens, jnp.int32), 0, jcfg)
    got, _ = forward(params, KVCache.create(cfg, 1, 32, dtype=torch.float32, device="cpu"),
                     torch.as_tensor(tokens), 0, cfg)
    return got.numpy(), np.asarray(want)


def test_export_matches_jax_byte_for_byte(tree):
    _, jcfg, cfg, jparams, params = tree
    jt, jmeta = jck.export_quantized(jparams, jcfg)
    tt, tmeta = tck.export_quantized(params, cfg)
    assert tmeta == jmeta
    assert list(tt) == list(jt)
    for name in jt:
        assert _torch_bytes(tt[name]) == _np_bytes(jt[name]), name


def test_native_roundtrip(tree, tmp_path):
    """export → save → load in the port: the tree comes back leaf for leaf
    (the loader stores every quantized leaf by `auto_orient`, as JAX's does)
    and the logits are those of JAX's own round trip."""
    _, jcfg, cfg, jparams, params = tree
    tensors, meta = tck.export_quantized(params, cfg)
    save_safetensors(tmp_path / "q.safetensors", tensors, meta)
    loaded = tck.load_quantized(open_safetensors(tmp_path / "q.safetensors"), cfg,
                                dtype=torch.float32, device="cpu", max_seq_len=jcfg.max_seq_len)
    jt, jm = jck.export_quantized(jparams, jcfg)
    jsave(tmp_path / "j.safetensors", jt, metadata=jm)
    jloaded = jck.load_quantized(JDocument.open(tmp_path / "j.safetensors"), jcfg,
                                 dtype=jnp.float32)
    assert_tree_equal(loaded, jax_tree_to_numpy(jloaded))
    got, want = _logits(jloaded, loaded, jcfg, cfg, [[7, 3, 9, 1, 4, 4]])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    orig, _ = _logits(jparams, params, jcfg, cfg, [[7, 3, 9, 1, 4, 4]])
    np.testing.assert_allclose(got, orig, rtol=0, atol=ATOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_between_packages(tree, writer, tmp_path):
    """A file the JAX package writes loads in the port, and the reverse:
    equal leaves (each package's loader on the same file) and logits."""
    _, jcfg, cfg, jparams, params = tree
    path = tmp_path / "cross.safetensors"
    if writer == "jax":
        jt, jm = jck.export_quantized(jparams, jcfg)
        jsave(path, jt, metadata=jm)
    else:
        save_safetensors(path, *tck.export_quantized(params, cfg))
    jloaded = jck.load_quantized(JDocument.open(path), jcfg, dtype=jnp.float32)
    loaded = tck.load_quantized(open_safetensors(path), cfg, dtype=torch.float32,
                                device="cpu", max_seq_len=jcfg.max_seq_len)
    assert_tree_equal(loaded, jax_tree_to_numpy(jloaded))
    got, want = _logits(jloaded, loaded, jcfg, cfg, [[2, 8, 1, 6]])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_other_int4_packing_refused(tmp_path):
    cfg = port_config(JLLAMA)
    path = tmp_path / "other.safetensors"
    save_safetensors(path, {"x": torch.zeros(1)}, {"bits": "4", "int4_packing": "adjacent"})
    with pytest.raises(ValueError, match="unsupported int4 packing 'adjacent'"):
        tck.load_quantized(open_safetensors(path), cfg, device="cpu")


# -- the reference QLoRA dialect -----------------------------------------------

def _reference_file(path, jcfg, *, tied: bool, g: int = 8, rank: int = 4, seed: int = 5):
    """A checkpoint in the reference's internal naming (int8 [out, in], f32
    scales [out, in/g], adaptors A [rank, in] / B [out, rank], f32 norms),
    as tests/test_quant_checkpoint.py builds it."""
    rng = np.random.default_rng(seed)
    L, H, F = jcfg.num_layers, jcfg.hidden_size, jcfg.intermediate_size
    nh, nkv, hd = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim

    def qw(out_dim, in_dim):
        q = rng.integers(-127, 128, (out_dim, in_dim)).astype(np.int8)
        s = (rng.random((out_dim, in_dim // g)) * 0.01 + 0.001).astype(np.float32)
        return q, s

    dims = {"attention.wq": (nh * hd, H), "attention.wk": (nkv * hd, H),
            "attention.wv": (nkv * hd, H), "attention.wo": (H, nh * hd),
            "feed_forward.w1": (F, H), "feed_forward.w2": (H, F), "feed_forward.w3": (F, H)}
    tensors = {}
    for i in range(L):
        for name, (o, inn) in dims.items():
            q, s = qw(o, inn)
            p = f"layers.{i}.{name}"
            tensors[p + ".weight"], tensors[p + ".scales"] = q, s
            tensors[p + ".adaptor.A.weight"] = \
                rng.standard_normal((rank, inn)).astype(np.float32) * 0.01
            tensors[p + ".adaptor.B.weight"] = \
                rng.standard_normal((o, rank)).astype(np.float32) * 0.01
        tensors[f"layers.{i}.attention_norm.weight"] = \
            (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
        tensors[f"layers.{i}.ffn_norm.weight"] = \
            (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    tensors["tok_embeddings.weight"] = rng.integers(-127, 128, (jcfg.vocab_size, H)).astype(
        np.int8)
    tensors["tok_embeddings.scales"] = (rng.random((jcfg.vocab_size, H // g)) * 0.01
                                        + 0.001).astype(np.float32)
    if not tied:
        tensors["output.weight"], tensors["output.scales"] = qw(jcfg.vocab_size, H)
    tensors["norm.weight"] = np.ones(H, np.float32)
    jsave(path, tensors)


@pytest.mark.parametrize("tied", [False, True], ids=["output", "tied"])
def test_reference_qlora_matches_jax(tied, tmp_path):
    jcfg = TINY_LLAMA if tied else JLLAMA
    cfg = port_config(jcfg)
    path = tmp_path / "qlora.safetensors"
    _reference_file(path, jcfg, tied=tied)
    jparams = jck.load_reference_qlora(JDocument.open(path), jcfg, group_size=8,
                                       dtype=jnp.float32)
    params = tck.load_reference_qlora(open_safetensors(path), cfg, group_size=8,
                                      dtype=torch.float32, device="cpu",
                                      max_seq_len=jcfg.max_seq_len)
    assert_tree_equal(params, jax_tree_to_numpy(jparams))
    wq, head = params["layers"]["wq"], params["lm_head"]
    assert isinstance(wq, LoraLinear) and wq.base.q.dtype == torch.int8
    assert params["layers"]["w1"].base.transposed and not wq.base.transposed
    assert isinstance(head, QuantizedTensor) and not head.transposed
    assert head.scales.dtype == torch.float32
    if tied:  # the swapped quantized embedding, natural [H, V]
        assert torch.equal(head.q, params["embed"].q.T)

    # 8 greedy steps after a 5-token prompt, each step's logits.
    ids, jids = [[3, 14, 15, 9, 2]], [[3, 14, 15, 9, 2]]
    jc = JKVCache.create(jcfg, 1, 32, dtype=jnp.float32)
    tc = KVCache.create(cfg, 1, 32, dtype=torch.float32, device="cpu")
    pos, toks = 0, ids[0]
    for _ in range(8):
        want, jc = jforward(jparams, jc, jnp.asarray([toks], jnp.int32), pos, jcfg)
        got, tc = forward(params, tc, torch.tensor([toks]), pos, cfg)
        want, got = np.asarray(want)[0, -1], got.numpy()[0, -1]
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())
        pos += len(toks)
        jids[0].append(int(want.argmax()))
        ids[0].append(int(got.argmax()))
        toks = [ids[0][-1]]
    assert ids == jids


def test_chip_qlora_writer_and_roundtrip_helpers(tmp_path):
    """chip_smoke's reference-dialect writer (`write_reference_qlora`, the
    qlora-1b phase's file) at the tiny Llama's widths on the CPU: the JAX
    loader and the port's give equal leaves; then the phase's round-trip
    checks (`native_roundtrip`, `roundtrip_logits`) pass on the CPU, the
    tied head turned by `auto_orient` on reload."""
    cfg = port_config(TINY_LLAMA)
    path = tmp_path / "chip.safetensors"
    chip_smoke.write_reference_qlora(path, cfg, rank=4, device="cpu", group=8)
    jparams = jck.load_reference_qlora(JDocument.open(path), TINY_LLAMA, group_size=8,
                                       dtype=jnp.float32)
    params = tck.load_reference_qlora(open_safetensors(path), cfg, group_size=8,
                                      dtype=torch.float32, device="cpu",
                                      max_seq_len=TINY_LLAMA.max_seq_len)
    assert_tree_equal(params, jax_tree_to_numpy(jparams))
    assert params["layers"]["wq"].a.shape == (cfg.num_layers, cfg.hidden_size, 4)
    sm = chip_smoke.Smoke(torch)
    reloaded, _, _ = chip_smoke.native_roundtrip(sm, "tiny-qlora", cfg, params,
                                                 tmp_path / "native.safetensors")
    assert reloaded["lm_head"].transposed and not params["lm_head"].transposed
    chip_smoke.roundtrip_logits(sm, "tiny-qlora", cfg, params, reloaded,
                                torch.tensor([[3, 14, 15, 9, 2, 6]]))
