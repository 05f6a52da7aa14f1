"""Model configuration (Llama, Gemma-3, Mixtral and GPT-2 families).

A trimmed copy of the JAX package's ``config.py``: the same frozen dataclasses
and the same HF ``config.json`` and Meta ``params.json`` mappings, so one
checkpoint directory configures both packages identically.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Optional, Tuple


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


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
    # Gemma-style extras (inert for Llama):
    norm_weight_offset: float = 0.0   # rmsnorm weight = offset + w (Gemma uses 1.0)
    use_qk_norm: bool = False
    use_post_norms: bool = False      # post-attention / post-ffn norms
    embedding_scale: Optional[float] = None  # Gemma multiplies embeddings by sqrt(hidden)
    hidden_act: str = "silu"          # "silu" (Llama) | "gelu_tanh" (Gemma)
    query_scale: Optional[float] = None  # attention score scale; default 1/sqrt(head_dim)
    # Sliding-window attention (Gemma-3 alternation):
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1   # every Nth layer is global; 1 == all global
    rope_local_theta: Optional[float] = None  # theta for sliding (local) layers
    # GPT-2-era architecture switches (inert for Llama/Gemma):
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    position_embedding: str = "rope"  # "rope" | "learned"
    ffn_type: str = "swiglu"          # "swiglu" | "mlp"
    use_bias: bool = False            # biases on attention/FFN projections
    # Mixture-of-experts (None → dense FFN): experts replace the FFN.
    num_experts: Optional[int] = None
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 2.0  # prefill dispatch capacity headroom
    bos_token_id: int = 128000
    eos_token_ids: Tuple[int, ...] = (128001, 128009)

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_is_global(self, layer_idx: int) -> bool:
        """Sliding-window layout: pattern N>1 → every Nth layer is global
        (Gemma-3 alternation); pattern 0 → every layer sliding; pattern 1 /
        no window → all global."""
        if self.sliding_window is None:
            return True
        if self.sliding_window_pattern == 0:
            return False
        if self.sliding_window_pattern == 1:
            return True
        return (layer_idx + 1) % self.sliding_window_pattern == 0

    def layer_window(self, layer_idx: int) -> int:
        """The attention window of layer ``layer_idx`` as the kernels take
        it: the sliding window, or -1 for a global layer."""
        return -1 if self.layer_is_global(layer_idx) else int(self.sliding_window)

    def attention_scale(self) -> float:
        """The score scale: ``query_scale``, else ``head_dim ** -0.5``."""
        return self.query_scale if self.query_scale is not None else self.head_dim ** -0.5

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
    def llama32_3b(**kw: Any) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=3072, intermediate_size=8192,
            num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
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
    def llama31_70b(**kw: Any) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
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

    @staticmethod
    def from_meta_params(cfg: Mapping[str, Any]) -> "LlamaConfig":
        """Map a Meta ``params.json``: the FFN width is derived from ``dim``
        (Llama's 2·4·dim/3, times ``ffn_dim_multiplier``, rounded up to
        ``multiple_of``); embeddings are tied, as the JAX package maps them."""
        dim = int(cfg["dim"])
        heads = int(cfg["n_heads"])
        inter = int(2 * (4 * dim) / 3)
        if "ffn_dim_multiplier" in cfg:
            inter = int(inter * float(cfg["ffn_dim_multiplier"]))
        inter = _round_up(inter, int(cfg.get("multiple_of", 256)))
        scaling = RopeScaling() if cfg.get("use_scaled_rope") else None
        return LlamaConfig(
            vocab_size=int(cfg.get("vocab_size", 128256)),
            hidden_size=dim,
            intermediate_size=inter,
            num_layers=int(cfg["n_layers"]),
            num_heads=heads,
            num_kv_heads=int(cfg.get("n_kv_heads", heads)),
            head_dim=dim // heads,
            rms_norm_eps=float(cfg.get("norm_eps", 1e-5)),
            rope_theta=float(cfg.get("rope_theta", 500000.0)),
            rope_scaling=scaling,
            tie_word_embeddings=True,
        )


@dataclass(frozen=True)
class Gemma3Config(ModelConfig):
    model_type: str = "gemma3"

    @staticmethod
    def gemma3_1b(**kw: Any) -> "Gemma3Config":
        """Gemma-3-1B-it text config (google/gemma-3-1b-it config.json)."""
        defaults: dict = dict(
            vocab_size=262144, hidden_size=1152, intermediate_size=6912,
            num_layers=26, num_heads=4, num_kv_heads=1, head_dim=256,
            rms_norm_eps=1e-6, rope_theta=1_000_000.0,
            rope_local_theta=10_000.0, sliding_window=512,
            sliding_window_pattern=6, max_seq_len=32768,
            tie_word_embeddings=True, norm_weight_offset=1.0,
            use_qk_norm=True, use_post_norms=True,
            embedding_scale=1152.0 ** 0.5, hidden_act="gelu_tanh",
            query_scale=256.0 ** -0.5, bos_token_id=2, eos_token_ids=(1, 106),
        )
        return Gemma3Config(**{**defaults, **kw})

    @staticmethod
    def gemma3_4b(**kw: Any) -> "Gemma3Config":
        """Gemma-3-4B-it text config (google/gemma-3-4b-it text_config)."""
        defaults: dict = dict(
            vocab_size=262208, hidden_size=2560, intermediate_size=10240,
            num_layers=34, num_heads=8, num_kv_heads=4, head_dim=256,
            rms_norm_eps=1e-6, rope_theta=1_000_000.0,
            rope_local_theta=10_000.0, sliding_window=1024,
            sliding_window_pattern=6, max_seq_len=131072,
            tie_word_embeddings=True, norm_weight_offset=1.0,
            use_qk_norm=True, use_post_norms=True,
            embedding_scale=2560.0 ** 0.5, hidden_act="gelu_tanh",
            query_scale=256.0 ** -0.5, bos_token_id=2, eos_token_ids=(1, 106),
        )
        return Gemma3Config(**{**defaults, **kw})

    @staticmethod
    def from_hf_config(cfg: Mapping[str, Any]) -> "Gemma3Config":
        """Map a HuggingFace Gemma-3 ``config.json``; a multimodal
        checkpoint nests the text model under ``text_config``."""
        if "text_config" in cfg:
            cfg = {**cfg, **cfg["text_config"]}
        heads = int(cfg.get("num_attention_heads", 8))
        hidden = int(cfg.get("hidden_size", 1152))
        qs = cfg.get("query_pre_attn_scalar")
        return Gemma3Config(
            vocab_size=int(cfg.get("vocab_size", 262144)),
            hidden_size=hidden,
            intermediate_size=int(cfg.get("intermediate_size", 6912)),
            num_layers=int(cfg.get("num_hidden_layers", 26)),
            num_heads=heads,
            num_kv_heads=int(cfg.get("num_key_value_heads", heads)),
            head_dim=int(cfg.get("head_dim", 256)),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            rope_theta=float(cfg.get("rope_theta", 1_000_000.0)),
            rope_local_theta=float(cfg.get("rope_local_base_freq", 10_000.0)),
            sliding_window=cfg.get("sliding_window"),
            sliding_window_pattern=int(cfg.get("sliding_window_pattern", 6)),
            max_seq_len=int(cfg.get("max_position_embeddings", 32768)),
            tie_word_embeddings=bool(cfg.get("tie_word_embeddings", True)),
            norm_weight_offset=1.0,
            use_qk_norm=True,
            use_post_norms=True,
            embedding_scale=float(hidden) ** 0.5,
            hidden_act="gelu_tanh",
            query_scale=(qs ** -0.5) if qs else None,
            bos_token_id=int(cfg.get("bos_token_id", 2)),
            eos_token_ids=_as_tuple(cfg.get("eos_token_id", (1, 106))),
        )


@dataclass(frozen=True)
class MixtralConfig(ModelConfig):
    """Mixtral sparse-MoE family (Llama-style attention + top-k expert FFN)."""

    model_type: str = "mixtral"

    @staticmethod
    def mixtral_8x7b(**kw: Any) -> "MixtralConfig":
        """mistralai/Mixtral-8x7B-v0.1's published widths."""
        return MixtralConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1_000_000.0, rms_norm_eps=1e-5, max_seq_len=32768,
            tie_word_embeddings=False, num_experts=8, num_experts_per_tok=2,
            bos_token_id=1, eos_token_ids=(2,), **kw,
        )

    @staticmethod
    def from_hf_config(cfg: Mapping[str, Any]) -> "MixtralConfig":
        """Map a HuggingFace Mixtral ``config.json``."""
        heads = int(cfg.get("num_attention_heads", 32))
        hidden = int(cfg.get("hidden_size", 4096))
        return MixtralConfig(
            vocab_size=int(cfg.get("vocab_size", 32000)),
            hidden_size=hidden,
            intermediate_size=int(cfg.get("intermediate_size", 14336)),
            num_layers=int(cfg.get("num_hidden_layers", 32)),
            num_heads=heads,
            num_kv_heads=int(cfg.get("num_key_value_heads", heads)),
            head_dim=int(cfg.get("head_dim", hidden // heads)),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
            rope_theta=float(cfg.get("rope_theta", 1_000_000.0)),
            max_seq_len=int(cfg.get("max_position_embeddings", 32768)),
            tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
            num_experts=int(cfg.get("num_local_experts", 8)),
            num_experts_per_tok=int(cfg.get("num_experts_per_tok", 2)),
            # Mixtral's sliding window (when set) applies to every layer.
            sliding_window=cfg.get("sliding_window"),
            sliding_window_pattern=0 if cfg.get("sliding_window") else 1,
            bos_token_id=int(cfg.get("bos_token_id", 1)),
            eos_token_ids=_as_tuple(cfg.get("eos_token_id", 2)),
        )


@dataclass(frozen=True)
class GPT2Config(ModelConfig):
    """GPT-2 family: layernorm, learned positions, biased GELU MLP, MHA.

    Built directly, it keeps ModelConfig's (Llama-like) switches, as the JAX
    package's does; `from_hf_config` sets GPT-2's."""

    model_type: str = "gpt2"

    @staticmethod
    def from_hf_config(cfg: Mapping[str, Any]) -> "GPT2Config":
        """Map a HuggingFace GPT-2 ``config.json``."""
        heads = int(cfg.get("n_head", 12))
        hidden = int(cfg.get("n_embd", 768))
        return GPT2Config(
            vocab_size=int(cfg.get("vocab_size", 50257)),
            hidden_size=hidden,
            intermediate_size=int(cfg.get("n_inner") or 4 * hidden),
            num_layers=int(cfg.get("n_layer", 12)),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            rms_norm_eps=float(cfg.get("layer_norm_epsilon", 1e-5)),
            max_seq_len=int(cfg.get("n_positions", 1024)),
            tie_word_embeddings=True,
            norm_type="layernorm",
            position_embedding="learned",
            ffn_type="mlp",
            use_bias=True,
            hidden_act="gelu_tanh",
            bos_token_id=int(cfg.get("bos_token_id", 50256)),
            eos_token_ids=_as_tuple(cfg.get("eos_token_id", 50256)),
        )


def _as_tuple(v: Any) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),)


def load_config(path: str | Path) -> ModelConfig:
    """Load a Llama, Gemma-3, Mixtral or GPT-2 config from a HF
    ``config.json``, or a Llama config from a Meta ``params.json``."""
    return config_from_dict(json.loads(Path(path).read_text()))


def config_from_dict(cfg: Mapping[str, Any]) -> ModelConfig:
    """Dispatch on ``model_type`` / ``architectures`` as the JAX package's
    ``config_from_dict`` does, for the families the port covers."""
    mt = cfg.get("model_type", "")
    archs = " ".join(cfg.get("architectures") or [])
    if mt.startswith("gemma") or "Gemma" in archs:
        return Gemma3Config.from_hf_config(cfg)
    if mt == "mixtral" or "Mixtral" in archs:
        return MixtralConfig.from_hf_config(cfg)
    if mt == "llama" or "Llama" in archs:
        return LlamaConfig.from_hf_config(cfg)
    if mt == "gpt2" or "GPT2" in archs:
        return GPT2Config.from_hf_config(cfg)
    if "dim" in cfg and "n_layers" in cfg:  # Meta params.json has no model_type
        return LlamaConfig.from_meta_params(cfg)
    raise ValueError(
        f"unsupported model config (model_type={mt!r}); this port covers the "
        "Llama, Gemma-3, Mixtral and GPT-2 families")


def merge_options(config: ModelConfig, overrides: Mapping[str, Any]) -> ModelConfig:
    """Apply dotted-path option overrides (the CLI manifest's ``[options]``,
    merged over its scopes) to a config: the last path component names
    the field."""
    fields = {f.name for f in dataclasses.fields(config)}
    updates: dict = {}
    for path, value in overrides.items():
        name = path.split(".")[-1]
        if name not in fields:
            raise KeyError(f"unknown option path {path!r}")
        if name == "rope_scaling" and isinstance(value, Mapping):
            value = RopeScaling(**value)
        if name == "eos_token_ids":
            value = _as_tuple(value)
        updates[name] = value
    return dataclasses.replace(config, **updates)
