"""Model configuration (Llama family).

A trimmed copy of the JAX package's ``config.py``: the same frozen dataclasses
and the same HF ``config.json`` mapping, so one checkpoint directory
configures both packages identically. Only the Llama family is kept; the
Gemma/Mixtral/GPT-2 configs belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Optional, Tuple


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 rope frequency scaling."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    """Common transformer hyperparameters (field names match the JAX package)."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    max_seq_len: int = 8192
    tie_word_embeddings: bool = True
    bos_token_id: int = 128000
    eos_token_ids: Tuple[int, ...] = (128001, 128009)

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LlamaConfig(ModelConfig):
    model_type: str = "llama"

    @staticmethod
    def llama32_1b(**kw: Any) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
            rope_theta=500000.0, rope_scaling=RopeScaling(factor=32.0),
            tie_word_embeddings=True, **kw,
        )

    @staticmethod
    def llama31_8b(**kw: Any) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=500000.0, rope_scaling=RopeScaling(),
            tie_word_embeddings=False, **kw,
        )

    @staticmethod
    def from_hf_config(cfg: Mapping[str, Any]) -> "LlamaConfig":
        """Map a HuggingFace Llama ``config.json``."""
        heads = int(cfg.get("num_attention_heads", 32))
        hidden = int(cfg.get("hidden_size", 2048))
        scaling = None
        rs = cfg.get("rope_scaling")
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            scaling = RopeScaling(
                factor=float(rs.get("factor", 8.0)),
                low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                original_max_position_embeddings=int(
                    rs.get("original_max_position_embeddings", 8192)
                ),
            )
        return LlamaConfig(
            vocab_size=int(cfg.get("vocab_size", 128256)),
            hidden_size=hidden,
            intermediate_size=int(cfg.get("intermediate_size", 8192)),
            num_layers=int(cfg.get("num_hidden_layers", 16)),
            num_heads=heads,
            num_kv_heads=int(cfg.get("num_key_value_heads", heads)),
            head_dim=int(cfg.get("head_dim", hidden // heads)),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
            rope_theta=float(cfg.get("rope_theta", 500000.0)),
            rope_scaling=scaling,
            max_seq_len=int(cfg.get("max_position_embeddings", 8192)),
            tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
            bos_token_id=int(cfg.get("bos_token_id", 128000)),
            eos_token_ids=_as_tuple(cfg.get("eos_token_id", (128001, 128009))),
        )


def _as_tuple(v: Any) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),)


def load_config(path: str | Path) -> LlamaConfig:
    """Load a Llama config from a HF ``config.json``."""
    cfg = json.loads(Path(path).read_text())
    archs = " ".join(cfg.get("architectures", []))
    if cfg.get("model_type") == "llama" or "Llama" in archs:
        return LlamaConfig.from_hf_config(cfg)
    raise ValueError(
        f"unsupported model config (model_type={cfg.get('model_type')!r}); "
        "this port covers the Llama family only")
