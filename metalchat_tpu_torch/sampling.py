"""Token samplers (port of the JAX package's ``sampling.py``).

Repetition, frequency and presence penalties against a token history
(`apply_penalties`), temperature, top-k, nucleus (top-p) and min-p masks,
then a categorical draw from an explicit ``torch.Generator``. Greedy is
``argmax`` (first index on ties, as ``jnp.argmax``). `sample` reads nothing
back to the host, so a decode step captured in a CUDA graph can call it.
`sample_batched` takes per-row settings, as the serving engine mixes
requests in one decode step, as host sequences or as device tensors (then
it too reads nothing back: the engine's captured burst step calls it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_NEG = float("-inf")


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.6
    top_k: int = 50
    top_p: float = 0.9
    min_p: float = 0.0               # keep tokens with p >= min_p * p_max
    repetition_penalty: float = 1.0  # > 1 penalizes seen tokens (CTRL-style)
    frequency_penalty: float = 0.0   # subtracted once per occurrence
    presence_penalty: float = 0.0    # subtracted once per seen token

    @staticmethod
    def greedy() -> "SamplerConfig":
        return SamplerConfig(temperature=0.0, top_k=0, top_p=1.0)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def penalizes(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.frequency_penalty != 0.0
                or self.presence_penalty != 0.0)


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


def apply_penalties(logits: torch.Tensor, history: torch.Tensor, config: SamplerConfig,
                    history_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Repetition (CTRL), frequency and presence penalties: logits ``[B,
    V]`` against the ids already in each row's context, ``history`` int
    ``[B, T]``; ``history_mask [B, T]`` (1 for a real token) leaves padding
    out. Counts are a scatter-add over the vocabulary, on the device."""
    if not config.penalizes:
        return logits
    ones = torch.ones(history.shape, dtype=torch.float32, device=logits.device)
    if history_mask is not None:
        ones = ones * history_mask.float()
    counts = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, history.long(), ones)
    seen = counts > 0.0
    out = logits.float()
    if config.repetition_penalty != 1.0:
        r = config.repetition_penalty
        out = torch.where(seen, torch.where(out > 0, out / r, out * r), out)
    out = out - counts * config.frequency_penalty
    return out - seen.float() * config.presence_penalty


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           config: SamplerConfig = SamplerConfig(),
           history: Optional[torch.Tensor] = None,
           history_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token ids ``[B]`` (int64) from logits ``[B, V]``, penalized
    against ``history`` first where the config asks for it. The draw is
    `torch.multinomial`'s own for one sample (``argmax(p / q)``, ``q ~
    Exp(1)`` from ``generator``), without its host-side checks."""
    logits = logits.float()
    if history is not None and config.penalizes:
        logits = apply_penalties(logits, history, config, history_mask)
    if config.is_greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / config.temperature
    logits = top_k_mask(logits, config.top_k)
    logits = top_p_mask(logits, config.top_p)
    logits = min_p_mask(logits, config.min_p)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    probs = torch.softmax(logits, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def truncation_keep(scaled: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k / top-p keep mask of temperature-scaled logits ``[B,
    V]``, sort-free: each truncation is a value threshold found by a 30-step
    bisection over the row's range. top-k keeps x while fewer than k values
    lie above it; top-p keeps x while the probability mass strictly above it
    is below p (``top_k`` 0 and ``top_p`` ≥ 1 disable). The argmax is always
    kept."""
    v = scaled.shape[-1]
    probs = torch.softmax(scaled, dim=-1)
    lo_k = lo_p = scaled.amin(dim=-1) - 1.0
    hi_k = hi_p = scaled.amax(dim=-1)
    k = torch.where(top_k <= 0, v, top_k)
    p = top_p.clamp(max=1.0)
    for _ in range(30):
        mid_k = 0.5 * (lo_k + hi_k)
        mid_p = 0.5 * (lo_p + hi_p)
        above_k = (scaled > mid_k[:, None]).sum(dim=-1)
        mass_p = torch.where(scaled > mid_p[:, None], probs, 0.0).sum(dim=-1)
        lo_k, hi_k = (torch.where(above_k < k, lo_k, mid_k),
                      torch.where(above_k < k, mid_k, hi_k))
        lo_p, hi_p = (torch.where(mass_p < p, lo_p, mid_p),
                      torch.where(mass_p < p, mid_p, hi_p))
    keep = scaled > lo_k[:, None]
    keep &= torch.where((p < 1.0)[:, None], scaled > lo_p[:, None], True)
    return keep.scatter(-1, scaled.argmax(dim=-1, keepdim=True), True)


def sampling_branch(temperature, top_k, top_p) -> str:
    """The work `sample_batched` does for rows with these host settings:
    "greedy" (no row draws), "draw" (draws, no truncation) or "truncate"
    (draws after `truncation_keep`). The JAX package picks the same branch
    on the device with ``lax.cond``; a CUDA graph cannot branch on device
    data, so the caller picks it from the settings it holds."""
    drawn = np.asarray(temperature, np.float32) > 0.0
    if not drawn.any():
        return "greedy"
    restricted = (np.asarray(top_k) > 0) | (np.asarray(top_p, np.float32) < 1.0)
    return "truncate" if np.any(drawn & restricted) else "draw"


def sample_batched(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temperature, top_k, top_p, branch: Optional[str] = None) -> torch.Tensor:
    """Next-token ids ``[B]`` with per-row settings: temperature (≤ 0 means
    greedy for that row), top-k (0 disables) and top-p (≥ 1 disables),
    each either a host sequence or a ``[B]`` tensor on the logits' device.
    With tensors the caller passes ``branch`` (`sampling_branch` of the same
    settings), and the call reads nothing back and copies nothing to the
    device, so a captured decode step can make it; host sequences are copied
    to the device and give the branch themselves. Draws are Gumbel-max from
    ``generator`` on the logits' device; greedy rows take the argmax."""
    logits = logits.float()
    argmax = torch.argmax(logits, dim=-1)
    if not torch.is_tensor(temperature):
        branch = sampling_branch(temperature, top_k, top_p)
        if branch != "greedy":
            dev = logits.device
            temperature = torch.from_numpy(np.asarray(temperature, np.float32)).to(dev)
            top_k = torch.from_numpy(np.asarray(top_k, np.int64)).to(dev)
            top_p = torch.from_numpy(np.asarray(top_p, np.float32)).to(dev)
    elif branch not in ("greedy", "draw", "truncate"):
        raise ValueError(f"sample_batched: settings as tensors need a branch, got {branch!r}")
    if branch == "greedy":
        return argmax
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    greedy = temperature <= 0.0
    scaled = logits / torch.where(greedy, 1.0, temperature)[:, None]
    if branch == "truncate":
        scaled = torch.where(truncation_keep(scaled, top_k, top_p), scaled, _NEG)
    u = torch.rand(scaled.shape, generator=generator, device=logits.device)
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(greedy, argmax, drawn)


def multinomial(probs: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF draw over probabilities ``probs [..., V]`` (the JAX
    package's ``multinomial``): int32 ids ``[...]``, each the count of
    cumulative sums below ``u`` times the row's total, ``u`` uniform in
    [0, 1) in the probabilities' dtype, drawn from ``generator`` or given
    as ``uniforms [..., 1]``. Provided for parity; `sample` draws by
    ``argmax(p / q)``."""
    cum = torch.cumsum(probs, dim=-1)
    if uniforms is None:
        uniforms = torch.rand(probs.shape[:-1] + (1,), generator=generator,
                              dtype=probs.dtype, device=probs.device)
    u = uniforms * cum[..., -1:]
    return (cum < u).sum(dim=-1).to(torch.int32)
