"""Perplexity: quantization quality measured over token streams (port of the
JAX package's ``quant/ppl.py``).

Teacher-forced NLL and perplexity of a parameter tree over token batches,
and the change between two trees (bf16 against int8/int4 of the same
weights), under the JAX package's names and result keys. Each batch is one
`forward` over a fresh cache on the parameters' device, so on the card the
prefill's flash attention carries it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import Params, forward


@torch.no_grad()
def token_nll(params: Params, config: ModelConfig, tokens: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              quantized_kv: bool = False) -> torch.Tensor:
    """Mean negative log-likelihood (f32, 0-d) of ``tokens[:, 1:]`` under
    teacher forcing. ``mask`` bool ``[B, S-1]`` picks the positions scored;
    ``quantized_kv`` scores through the int8 KV cache."""
    device = params["final_norm"].device
    tokens = tokens.to(device)
    b, s = tokens.shape
    if quantized_kv:
        cache = QuantizedKVCache.create(config, b, s, device=device)
    else:
        cache = KVCache.create(config, b, s, dtype=params["final_norm"].dtype, device=device)
    logits, _ = forward(params, cache, tokens, 0, config)
    logprobs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = logprobs.gather(-1, tokens[:, 1:, None].long())[..., 0]
    if mask is None:
        return -picked.mean()
    mask = mask.to(device=device, dtype=torch.float32)
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


def _as_tokens(batch) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch), dtype=torch.int64)


def perplexity(params: Params, config: ModelConfig, tokens, mask=None) -> float:
    """exp of `token_nll` over one batch."""
    return float(torch.exp(token_nll(params, config, _as_tokens(tokens), mask)))


def perplexity_delta(reference_params: Params, candidate_params: Params,
                     config: ModelConfig, token_batches: Sequence) -> Dict[str, float]:
    """Compare two parameter trees over a token corpus: each perplexity is
    exp of the mean of the batches' NLLs. Returns ``{"reference",
    "candidate", "delta", "delta_pct"}``."""
    ref_nll, cand_nll = [], []
    for batch in token_batches:
        batch = _as_tokens(batch)
        ref_nll.append(float(token_nll(reference_params, config, batch)))
        cand_nll.append(float(token_nll(candidate_params, config, batch)))
    ref = float(np.exp(np.mean(ref_nll)))
    cand = float(np.exp(np.mean(cand_nll)))
    return {
        "reference": ref,
        "candidate": cand,
        "delta": cand - ref,
        "delta_pct": 100.0 * (cand - ref) / ref,
    }
