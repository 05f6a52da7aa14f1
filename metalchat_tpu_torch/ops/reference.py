"""Plain PyTorch reference ops (port of the JAX package's ``ops/xla.py``).

Every function keeps the op order of its JAX counterpart, so the two agree
to float rounding in f32 (tests/test_torch_ops.py). Reductions and softmax
statistics run in float32 whatever the activation dtype. Layouts match the
JAX package: q ``[B, S, nh, hd]``, head-major KV ``[B, n_kv, T, hd]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from metalchat_tpu_torch.config import RopeScaling

# -0.7 * float32 max: an additive mask that never yields NaN through exp.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMS normalization; the effective scale is ``offset + weight``."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Classic LayerNorm (GPT-2 family): f32 statistics, weight and bias
    applied in f32, one cast back to x's dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(dtype)


def scale_rope_freqs(freqs: torch.Tensor, scaling: RopeScaling) -> torch.Tensor:
    """Llama-3.1 rope frequency scaling."""
    low_wavelen = scaling.original_max_position_embeddings / scaling.low_freq_factor
    high_wavelen = scaling.original_max_position_embeddings / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (scaling.original_max_position_embeddings / wavelen
              - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    return torch.where(
        wavelen < high_wavelen,
        freqs,
        torch.where(
            wavelen > low_wavelen,
            freqs / scaling.factor,
            (1.0 - smooth) / scaling.factor * freqs + smooth * freqs,
        ),
    )


def precompute_rope(head_dim: int, max_seq_len: int, theta: float,
                    scaling: Optional[RopeScaling] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[max_seq_len, head_dim//2]`` in float32, computed on
    the CPU (so every device gets the same table) and moved to ``device``."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / (theta ** exponents)
    if scaling is not None:
        freqs = scale_rope_freqs(freqs, scaling)
    angles = torch.outer(torch.arange(max_seq_len, dtype=torch.float32), freqs)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """HF-style half-split rotation. x ``[B, S, nh, hd]``; positions ``[B, S]``."""
    return _rotate(x, cos[positions][:, :, None, :], sin[positions][:, :, None, :])


def apply_rope_rows(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """`apply_rope` with pre-gathered rows: cos/sin ``[B, S, hd//2]``."""
    return _rotate(x, cos[:, :, None, :].float(), sin[:, :, None, :].float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, *, scale: float, weights_dtype=None) -> torch.Tensor:
    """GQA attention over a (padded) head-major KV buffer.

    q ``[B, S, nh, hd]``; k, v ``[B, n_kv, T, hd]``; mask ``[B or 1, S, T]``
    boolean, True where attention is allowed. Softmax weights are cast to
    ``v.dtype`` (or ``weights_dtype``: that of a cache whose k and v come
    here already in f32) before the PV product, as in the JAX reference.
    """
    b, s, nh, hd = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    groups = nh // n_kv
    qg = q.reshape(b, s, n_kv, groups, hd)
    scores = torch.einsum("bskgd,bktd->bkgst", qg.float(), k.float())
    scores = scores * scale
    scores = torch.where(mask[:, None, None, :, :], scores, MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bskgd", weights.to(weights_dtype or v.dtype).float(),
                       v.float())
    return out.reshape(b, s, nh, hd).to(q.dtype)


def causal_mask(positions: torch.Tensor, kv_len: int, kv_valid_len,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """Boolean mask ``[B, S, kv_len]``: kv_pos ≤ q_pos, kv_pos < valid length,
    and (if sliding) kv_pos > q_pos - window."""
    kv_pos = torch.arange(kv_len, dtype=torch.int32,
                          device=positions.device)[None, None, :]
    q_pos = positions[:, :, None]
    ok = (kv_pos <= q_pos) & (kv_pos < kv_valid_len)
    if sliding_window is not None:
        ok &= kv_pos > q_pos - sliding_window
    return ok


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": torch.nn.functional.silu, "gelu_tanh": gelu_tanh}


def activation(name: str):
    """The gate activation ``name`` ("silu" or "gelu_tanh")."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return ACTIVATIONS[name]


def swiglu(x, w1, w3, w2, act: str, matmul=None) -> torch.Tensor:
    """Gated feed-forward ``w2(act(x·w1) ⊙ (x·w3))`` with [in, out] weights."""
    if matmul is None:
        matmul = lambda a, w: a @ w  # noqa: E731
    gate = activation(act)(matmul(x, w1))
    return matmul(gate * matmul(x, w3), w2)
