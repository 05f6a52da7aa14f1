"""The port's perplexity harness (metalchat_tpu_torch/quant/ppl.py) against
the JAX package's quant/ppl.py on the trained fixture
(tests/fixtures/pyllama_10m), f32 activations on the CPU.

Parameters cross as numpy bytes; both packages score the same batches of
`eval_tokens.npy`. Tolerances:

* dense parameters (and weight-only int4/int8, whose product is the
  dequantized weight in f32 on both sides): every NLL and perplexity within
  1e-5 relative (float rounding only; one op order);
* the int8 KV cache: the NLL within 1e-4 relative (a K/V element that the
  two packages compute an ulp apart and that sits at a rounding boundary
  gets codes one quantum apart, and the later layers' inputs move by that
  quantum's effect: Queue C, an int8 cache cascades one code flip; 1.7e-5
  measured);
* W8A8 and W4A8: the candidate's mean NLL within 2e-3 relative. An ulp
  upstream can move one int8 activation code by a quantum (Queue C, the
  act-quant drift), and over a 64-token prefill of 6 layers the flips
  cascade: the logits part by a median 0.3-0.9% of each row's largest on
  these batches, the same before this module existed (the layer route's
  own drift); the mean NLL moved by 8e-4 relative at most.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.quant import ppl as jppl
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.quant import perplexity, perplexity_delta, token_nll
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
MAX_SEQ = 128
DENSE_RTOL = 1e-5
INT8_KV_RTOL = 1e-4
A8_NLL_RTOL = 2e-3


@pytest.fixture(scope="module")
def fixture():
    jcfg = jload_config(FIXTURE / "config.json")
    jparams = jload_params(jopen(FIXTURE), jcfg, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    tokens = np.load(FIXTURE / "eval_tokens.npy").astype(np.int64)
    batches = [tokens[i * 128:(i + 1) * 128].reshape(2, 64) for i in (3, 11)]
    return jcfg, load_config(FIXTURE / "config.json"), jparams, batches


def _port(jparams):
    return params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def _mask(batch):
    """Score only the positions whose target is not a space (byte 32): a
    mask that drops about a fifth of the positions."""
    return batch[:, 1:] != 32


@pytest.mark.parametrize("quantized_kv", [False, True], ids=["dense-kv", "int8-kv"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_token_nll_matches_jax(fixture, quantized_kv, masked):
    jcfg, cfg, jparams, batches = fixture
    batch = batches[0]
    mask = _mask(batch) if masked else None
    assert mask is None or 0.5 < mask.mean() < 0.95
    want = float(jppl.token_nll(jparams, jcfg, jnp.asarray(batch, jnp.int32),
                                None if mask is None else jnp.asarray(mask), quantized_kv))
    got = token_nll(_port(jparams), cfg, torch.from_numpy(batch),
                    None if mask is None else torch.from_numpy(mask), quantized_kv)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want,
                               rtol=INT8_KV_RTOL if quantized_kv else DENSE_RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_perplexity_matches_jax(fixture, masked):
    jcfg, cfg, jparams, batches = fixture
    batch = batches[1]
    mask = _mask(batch) if masked else None
    want = jppl.perplexity(jparams, jcfg, batch, None if mask is None else jnp.asarray(mask))
    got = perplexity(_port(jparams), cfg, batch,
                     None if mask is None else torch.from_numpy(mask))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=DENSE_RTOL)


CANDIDATES = {
    "int4 g32": (dict(bits=4, group_size=32), DENSE_RTOL),
    "int4 g32 clip_search": (dict(bits=4, group_size=32, clip_search=True), DENSE_RTOL),
    "int8 g32 quantize_embed": (dict(bits=8, group_size=32, quantize_embed=True), DENSE_RTOL),
    "w8a8": (dict(bits=8, group_size=None, act_bits=8), A8_NLL_RTOL),
    "w4a8 fused": (dict(bits=4, group_size=None, act_bits=8), A8_NLL_RTOL),
}


@pytest.mark.parametrize("name", list(CANDIDATES))
def test_perplexity_delta_matches_jax(fixture, name):
    jcfg, cfg, jparams, batches = fixture
    quant, rtol = CANDIDATES[name]
    jcand = jquantize_params(jparams, **quant)
    if name.endswith("fused"):
        jcand = jfuse(jcand, jcfg)
    want = jppl.perplexity_delta(jparams, jcand, jcfg, batches)
    got = perplexity_delta(_port(jparams), _port(jcand), cfg, batches)
    assert set(got) == set(want) == {"reference", "candidate", "delta", "delta_pct"}
    np.testing.assert_allclose(got["reference"], want["reference"], rtol=DENSE_RTOL)
    # The candidate by its mean NLL (the log of the perplexity).
    np.testing.assert_allclose(np.log(got["candidate"]), np.log(want["candidate"]), rtol=rtol)
    np.testing.assert_allclose(got["delta"], got["candidate"] - got["reference"], rtol=1e-12)
    np.testing.assert_allclose(got["delta_pct"], 100 * got["delta"] / got["reference"],
                               rtol=1e-12)
    assert got["candidate"] != got["reference"]  # the tree was quantized
