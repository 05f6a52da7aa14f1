"""Port sampling masks and Llama config (metalchat_tpu_torch/sampling.py,
config.py) vs the JAX package's sampling.py and config.py, on the CPU.

The masks keep or drop the same tokens and leave kept logits untouched, so
the comparison is exact. Stochastic draws are not compared: a
``torch.Generator`` and a JAX key give different numbers from one seed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu import sampling as jsampling
from metalchat_tpu.config import LlamaConfig as JLlama
from metalchat_tpu_torch import sampling
from metalchat_tpu_torch.config import LlamaConfig

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
LOGITS = np.random.default_rng(0).standard_normal((4, 97)).astype(np.float32) * 3


@pytest.mark.parametrize("name,arg", [
    ("top_k_mask", 5), ("top_k_mask", 0), ("top_p_mask", 0.7), ("top_p_mask", 1.0),
    ("min_p_mask", 0.1), ("min_p_mask", 0.0),
])
def test_masks_identical(name, arg):
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(LOGITS), arg))

    got = getattr(sampling, name)(torch.from_numpy(LOGITS), arg).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_and_stochastic_sample():
    want = np.asarray(jsampling.sample(jnp.asarray(LOGITS), None,
                                       jsampling.SamplerConfig.greedy()))

    logits = torch.from_numpy(LOGITS)
    np.testing.assert_array_equal(
        sampling.sample(logits, None, sampling.SamplerConfig.greedy()).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    cfg = sampling.SamplerConfig(temperature=0.8, top_k=5, top_p=0.9)
    kept = torch.isfinite(sampling.top_k_mask(logits / 0.8, 5))
    for _ in range(8):
        ids = sampling.sample(logits, gen, cfg)
        assert kept[torch.arange(4), ids].all()  # draws only from the top-k
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample(logits, None, cfg)


def _as_dict(cfg):
    """The port's config fields, read from either package's config."""
    out = {f: getattr(cfg, f) for f in LlamaConfig.__dataclass_fields__}
    out["rope_scaling"] = None if cfg.rope_scaling is None else vars(cfg.rope_scaling)
    return out


def test_llama_configs_match():
    raw = json.loads((FIXTURE / "config.json").read_text())
    hf_8b = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
             "rope_scaling": {"rope_type": "llama3", "factor": 8.0}, "eos_token_id": 7}
    want = [_as_dict(c) for c in (JLlama.llama31_8b(max_seq_len=1024), JLlama.llama32_1b(),
                                  JLlama.from_hf_config(raw), JLlama.from_hf_config(hf_8b))]

    got = [_as_dict(c) for c in (LlamaConfig.llama31_8b(max_seq_len=1024),
                                 LlamaConfig.llama32_1b(), LlamaConfig.from_hf_config(raw),
                                 LlamaConfig.from_hf_config(hf_8b))]
    assert got == want
