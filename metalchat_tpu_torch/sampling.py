"""Token samplers (port of the JAX package's ``sampling.py``).

Temperature, top-k, nucleus (top-p) and min-p masks, then a categorical
draw from an explicit ``torch.Generator``. Greedy is ``argmax`` (first index
on ties, as ``jnp.argmax``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_NEG = float("-inf")


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.6
    top_k: int = 50
    top_p: float = 0.9
    min_p: float = 0.0   # keep tokens with p >= min_p * p_max

    @staticmethod
    def greedy() -> "SamplerConfig":
        return SamplerConfig(temperature=0.0, top_k=0, top_p=1.0)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, -inf elsewhere."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= threshold, logits, _NEG)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest descending-probability prefix
    whose mass reaches p (the crossing token is kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    idx = (exclusive < p).sum(dim=-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_logits, -1, idx)
    return torch.where(logits >= cutoff, logits, _NEG)


def min_p_mask(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Keep tokens whose probability is at least min_p × p(argmax)."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.amax(dim=-1, keepdim=True) * min_p
    return torch.where(probs >= cutoff, logits, _NEG)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           config: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Next-token ids ``[B]`` (int64) from logits ``[B, V]``."""
    logits = logits.float()
    if config.is_greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / config.temperature
    logits = top_k_mask(logits, config.top_k)
    logits = top_p_mask(logits, config.top_p)
    logits = min_p_mask(logits, config.min_p)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
