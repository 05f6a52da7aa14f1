"""AWQ in the port (metalchat_tpu_torch/quant/awq.py) against the JAX
package's quant/awq.py, on the CPU.

Models: the trained fixture (tests/fixtures/pyllama_10m), the tiny Llama
and the tiny Gemma-3 of tests/test_model.py (q/k norms, post norms, sliding
layers with their own rope table, gelu-tanh, a query scale). Parameters
cross as numpy bytes. Tolerances:

* `calibration_stats`: each tap within 1e-5 relative of its largest value
  (f32 products whose sums the two packages order differently);
* `awq_fold` on the same statistics: every leaf byte-equal, in f32 and in
  bf16 (f64 saliency scales cast to f32, then f32 products and quotients,
  each rounded as numpy rounds them);
* `awq_quantize_params` on the JAX package's statistics: packed codes and
  scales equal; end to end on the port's own statistics, whose taps may sit
  an ulp away: at most 1e-5 of the codes differ, each by one quantum, and
  the scales within 1e-6 relative.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models.transformer import init_random_params as jinit_random_params
from metalchat_tpu.quant import awq as jawq
from metalchat_tpu_torch.config import MixtralConfig
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.quant import awq
from test_model import TINY_GEMMA, TINY_LLAMA
from torch_port_util import jax_tree_to_numpy, port_config

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
STATS_RTOL = 1e-5


def _model(name: str, dtype=jnp.float32):
    if name == "fixture":
        jcfg = jload_config(FIXTURE / "config.json")
        jparams = jload_params(jopen(FIXTURE), jcfg, dtype=dtype, max_seq_len=64)
        tokens = np.load(FIXTURE / "eval_tokens.npy")[:4 * 48].reshape(4, 48)
    else:
        jcfg = {"tiny-llama": TINY_LLAMA, "tiny-gemma": TINY_GEMMA}[name]
        jparams = jinit_random_params(jcfg, seed=4, dtype=dtype)
        tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (3, 24))
    return jcfg, port_config(jcfg), jparams, tokens.astype(np.int32)


def _port(jparams):
    return params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def _bytes(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str if a.dtype.name != "bfloat16" else "bf16", a.shape, a.view(np.uint8)


def _torch_bytes(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return "bf16", tuple(t.shape), t.view(torch.int16).numpy().view(np.uint8)
    a = t.numpy()
    return a.dtype.str, a.shape, a.view(np.uint8)


@pytest.mark.parametrize("model", ["fixture", "tiny-llama", "tiny-gemma"])
def test_calibration_stats_match_jax(model):
    jcfg, cfg, jparams, tokens = _model(model)
    want = jawq.calibration_stats(jparams, jcfg, jnp.asarray(tokens))
    got = awq.calibration_stats(_port(jparams), cfg, torch.from_numpy(tokens))
    assert set(got) == set(want) == {"qkv", "wo", "w13", "w2"}
    for tap in want:
        w, g = np.asarray(want[tap]), got[tap].numpy()
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=STATS_RTOL * np.abs(w).max(), err_msg=tap)


def test_calibration_refuses_moe():
    cfg = MixtralConfig.mixtral_8x7b().replace(num_layers=1)
    with pytest.raises(NotImplementedError, match="dense FFN models only"):
        awq.calibration_stats({"final_norm": torch.ones(1)}, cfg, torch.zeros(1, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["fixture", "tiny-gemma"])
@pytest.mark.parametrize("alpha", [0.1, 0.5])
def test_awq_fold_bytes_match_jax(model, dtype, alpha):
    """On the JAX package's statistics, every folded leaf byte for byte."""
    jcfg, cfg, jparams, tokens = _model(model, getattr(jnp, dtype))
    stats = jawq.calibration_stats(jparams, jcfg, jnp.asarray(tokens))
    want = jax_tree_to_numpy(jawq.awq_fold(jparams, jcfg, stats, alpha=alpha))
    got = awq.awq_fold(_port(jparams), cfg,
                       {k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()},
                       alpha=alpha)
    assert list(got["layers"]) == list(want["layers"])
    for name, leaf in want["layers"].items():
        wd, ws, wb = _bytes(leaf)
        gd, gs, gb = _torch_bytes(got["layers"][name])
        assert (gd, gs) == (wd, ws), name
        assert np.array_equal(gb, wb), f"{name}: {int((gb != wb).sum())} bytes differ"


def test_saliency_scale_matches_jax():
    stat = np.random.default_rng(0).random((3, 40)).astype(np.float32) * 5
    stat[1, 7] = 0.0  # clamped to 1e-8 before the power
    for alpha in (0.1, 0.35, 0.5):
        np.testing.assert_array_equal(
            awq._saliency_scale(torch.from_numpy(stat), alpha).numpy(),
            jawq._saliency_scale(stat, alpha))


def _codes(leaf, bits):
    """Signed codes [.., out, in] of a transposed per-channel leaf."""
    q = np.asarray(leaf["q"]).astype(np.int16)
    if bits == 4:
        q = np.concatenate([(q & 15) - 8, q >> 4], axis=-1)
    return q


@pytest.mark.parametrize("bits", [4, 8])
def test_awq_quantize_params_codes_match_jax(bits, monkeypatch):
    """Fold and per-channel quantize with clip search on the JAX package's
    statistics (the port's `calibration_stats` answering with them): packed
    codes, scales and norms equal."""
    jcfg, cfg, jparams, tokens = _model("fixture")
    stats = jawq.calibration_stats(jparams, jcfg, jnp.asarray(tokens))
    monkeypatch.setattr(awq, "calibration_stats", lambda *a, **k: {
        n: torch.from_numpy(np.asarray(v)) for n, v in stats.items()})
    want = jax_tree_to_numpy(jawq.awq_quantize_params(
        jparams, jcfg, jnp.asarray(tokens), bits=bits, alpha=0.35))
    got = awq.awq_quantize_params(_port(jparams), cfg, torch.from_numpy(tokens), bits=bits,
                                  alpha=0.35)
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        w, g = want["layers"][name], got["layers"][name]
        assert (g.bits, g.group_size, g.transposed, g.act_bits) == (
            w["bits"], w["group_size"], w["transposed"], w["act_bits"])
        np.testing.assert_array_equal(g.q.numpy(), w["q"], err_msg=name)
        np.testing.assert_array_equal(g.scales.numpy(), w["scales"], err_msg=name)
    for name in ("attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(got["layers"][name].numpy(), want["layers"][name])


@pytest.mark.parametrize("bits", [4, 8])
def test_awq_quantize_params_end_to_end(bits):
    """The whole pipeline on the port's own statistics: a tap an ulp off
    moves a saliency scale by an ulp, which moves a code that sits on a
    rounding boundary (measured: 2 codes of 884,736 in wq). At most 1e-5 of
    the codes differ, each by one quantum; scales within 1e-6 relative."""
    jcfg, cfg, jparams, tokens = _model("fixture")
    want = jax_tree_to_numpy(jawq.awq_quantize_params(
        jparams, jcfg, jnp.asarray(tokens), bits=bits, alpha=0.35))
    got = _port_leaves(awq.awq_quantize_params(
        _port(jparams), cfg, torch.from_numpy(tokens), bits=bits, alpha=0.35))
    for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
        d = _codes(got[name], bits) - _codes(want["layers"][name], bits)
        assert np.abs(d).max() <= 1 and (d != 0).mean() <= 1e-5, name
        np.testing.assert_allclose(got[name]["scales"], want["layers"][name]["scales"],
                                   rtol=1e-6, err_msg=name)


def _port_leaves(params):
    """The port's quantized layer leaves as the dicts `_codes` reads."""
    return {n: {"q": leaf.q.numpy(), "scales": leaf.scales.numpy()}
            for n, leaf in params["layers"].items() if hasattr(leaf, "q")}
