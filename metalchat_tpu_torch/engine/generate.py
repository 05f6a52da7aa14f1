"""Generation loop (port of the JAX package's ``engine/generate.py``).

A Python loop: one prefill `forward` over the prompt, then one decode step
per token, sampling between steps. The JAX package runs the whole loop as
one compiled program; capturing the decode step in a CUDA graph is the
counterpart here and is later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.models.transformer import Cache, Params, forward
from metalchat_tpu_torch.sampling import SamplerConfig, sample


def _eos_hit(tokens: torch.Tensor, eos_ids: Tuple[int, ...]) -> torch.Tensor:
    if not eos_ids:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    eos = torch.tensor(eos_ids, dtype=tokens.dtype, device=tokens.device)
    return (tokens[:, None] == eos[None, :]).any(dim=-1)


@torch.no_grad()
def generate(params: Params, config: ModelConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, sampler: SamplerConfig = SamplerConfig.greedy(),
             eos_ids: Tuple[int, ...] = (), seed: int = 0,
             cache: Optional[Cache] = None, quantized_kv: bool = False,
             max_seq_len: Optional[int] = None, ffn_block: bool = False) -> torch.Tensor:
    """Prompt ``[B, S]`` → generated ids ``[B, max_new_tokens]`` (int64).

    Same token semantics as the JAX package: the first token comes from the
    prefill logits; a row that hits an EOS id repeats it from then on. Runs
    on the device of the parameters; the default cache holds the prompt
    and the new tokens, dense in the activation dtype or int8.
    ``ffn_block`` merges each decode step's post-attention block into one
    kernel launch a layer (`decode_step`)."""
    device = params["final_norm"].device
    prompt = prompt.to(device)
    b, s = prompt.shape
    if cache is None:
        limit = max_seq_len or min(config.max_seq_len, s + max_new_tokens)
        if quantized_kv:
            cache = QuantizedKVCache.create(config, b, limit, device=device)
        else:
            cache = KVCache.create(config, b, limit,
                                   dtype=params["final_norm"].dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    logits, cache = forward(params, cache, prompt, 0, config, ffn_block=ffn_block)
    tok = sample(logits[:, -1], gen, sampler)
    done = _eos_hit(tok, eos_ids)
    out = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = forward(params, cache, tok[:, None], s + i, config,
                                ffn_block=ffn_block)
        nxt = sample(logits[:, -1], gen, sampler)
        hit = done | _eos_hit(nxt, eos_ids)
        tok = torch.where(done, tok, nxt)
        done = hit
        out.append(tok)
    return torch.stack(out, dim=1)
