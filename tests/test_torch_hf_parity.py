"""The port's Llama loader and `forward` against a `LlamaForCausalLM` built
in-process from a config (random weights, torch on the CPU), as
tests/test_hf_parity.py holds the JAX package: the model's state dict is
written with the port's `save_safetensors`, read back through the port's
native mapping and `load_params`, and the prefill's logits compared.

Tolerance: 2e-3 relative and absolute, tests/test_hf_parity.py's (f32 on
both sides; the two frameworks order their sums differently and the
reference computes attention through another kernel).
"""

import numpy as np
import pytest
import torch

from metalchat_tpu_torch.cache import KVCache
from metalchat_tpu_torch.config import LlamaConfig
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from metalchat_tpu_torch.models.transformer import forward

transformers = pytest.importorskip("transformers")

HF = dict(vocab_size=160, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=16,
          max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
          attention_bias=False, mlp_bias=False)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_llama_matches_transformers(tmp_path, tied):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(1)
    model = LlamaForCausalLM(HFConfig(**HF, tie_word_embeddings=tied)).eval()
    state = {n: p.detach().contiguous() for n, p in model.state_dict().items()
             if "rotary_emb" not in n and not (tied and n == "lm_head.weight")}
    save_safetensors(tmp_path / "model.safetensors", state)

    cfg = LlamaConfig(vocab_size=160, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                      rope_scaling=None, max_seq_len=64, tie_word_embeddings=tied)
    params = load_params(open_safetensors(tmp_path / "model.safetensors"), cfg,
                         dtype=torch.float32, device="cpu")
    tokens = torch.tensor([[3, 141, 59, 26, 5, 97, 0, 159]])
    with torch.no_grad():
        want = model(tokens).logits.numpy()
    cache = KVCache.create(cfg, 1, tokens.shape[1] + 4, dtype=torch.float32, device="cpu")
    got, _ = forward(params, cache, tokens, 0, cfg)
    assert np.abs(want).max() > 0.05  # random weights give non-trivial logits
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
