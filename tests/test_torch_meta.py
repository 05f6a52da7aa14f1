"""Meta-format Llama checkpoints in the port (config.from_meta_params, the
``params.json`` branch of load_config, io.safetensors rename/alias,
io.loaders ``source="meta"``, FilesystemRepository.retrieve_config) against
the JAX package, on the CPU.

Configs are compared field by field, exactly. The q/k permutation is held
to the JAX package's bit for bit. The Meta checkpoint is written in the test
from the trained fixture (HF names renamed to Meta's, q/k rows permuted
back to Meta's interleaved rope layout, lm_head dropped where the
embeddings are tied): loaded with ``source="meta"`` it gives exactly the HF
checkout's parameters and exactly the JAX package's ``load_params(...,
source="meta")`` weights.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.loaders import permute_qk_meta_to_hf as jpermute
from metalchat_tpu.io.repository import FilesystemRepository as JFilesystemRepository
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu_torch.config import LlamaConfig, config_from_dict, load_config
from metalchat_tpu_torch.io.loaders import load_params, permute_qk_meta_to_hf
from metalchat_tpu_torch.io.repository import FilesystemRepository
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from torch_port_util import jax_tree_to_numpy

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"

# Meta params.json files: Llama-3.1-8B's and Llama-3.2-1B's published ones,
# and variants without the optional keys.
PARAMS = {
    "llama-3.1-8b": {"dim": 4096, "ffn_dim_multiplier": 1.3, "multiple_of": 1024,
                     "n_heads": 32, "n_kv_heads": 8, "n_layers": 32, "norm_eps": 1e-05,
                     "rope_theta": 500000.0, "use_scaled_rope": True,
                     "vocab_size": 128256},
    "llama-3.2-1b": {"dim": 2048, "ffn_dim_multiplier": 1.5, "multiple_of": 256,
                     "n_heads": 32, "n_kv_heads": 8, "n_layers": 16, "norm_eps": 1e-05,
                     "rope_theta": 500000.0, "use_scaled_rope": True,
                     "vocab_size": 128256},
    "llama-2-7b": {"dim": 4096, "multiple_of": 256, "n_heads": 32, "n_layers": 32,
                   "norm_eps": 1e-06, "vocab_size": 32000},
    "bare": {"dim": 384, "n_heads": 6, "n_layers": 6},
    "no-multiple": {"dim": 512, "n_heads": 8, "n_kv_heads": 2, "n_layers": 2,
                    "ffn_dim_multiplier": 1.0, "use_scaled_rope": False},
}


def fields(cfg):
    """Every field of the port's LlamaConfig as plain data (rope scaling as
    a dict); the JAX config has these and GPT-2's switches besides."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(LlamaConfig) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_from_meta_params_matches_jax(name, tmp_path):
    spec = PARAMS[name]
    want = fields(JLlamaConfig.from_meta_params(spec))
    assert fields(LlamaConfig.from_meta_params(spec)) == want
    assert fields(config_from_dict(spec)) == want
    (tmp_path / "params.json").write_text(json.dumps(spec))
    assert fields(load_config(tmp_path / "params.json")) == want
    assert fields(load_config(tmp_path / "params.json")) == fields(
        jload_config(tmp_path / "params.json"))


@pytest.mark.parametrize("preset", ["llama32_1b", "llama32_3b", "llama31_8b", "llama31_70b"])
def test_presets_match_jax(preset):
    assert fields(getattr(LlamaConfig, preset)()) == fields(getattr(JLlamaConfig, preset)())
    kw = dict(max_seq_len=1024)
    assert fields(getattr(LlamaConfig, preset)(**kw)) == fields(
        getattr(JLlamaConfig, preset)(**kw))


@pytest.mark.parametrize("heads,hd,hidden", [(4, 16, 24), (6, 64, 384), (2, 128, 8)])
def test_permute_qk_matches_jax(heads, hd, hidden):
    w = np.random.default_rng(heads).standard_normal((heads * hd, hidden)).astype(np.float32)
    got = permute_qk_meta_to_hf(torch.from_numpy(w), heads)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpermute(w, heads)))


def hf_to_meta(w: torch.Tensor, heads: int) -> torch.Tensor:
    """The inverse of the permutation: HF's half-split rows → Meta's
    interleaved ones."""
    out_dim, in_dim = w.shape
    hd = out_dim // heads
    return w.reshape(heads, 2, hd // 2, in_dim).permute(0, 2, 1, 3).reshape(out_dim, in_dim)


META_NAMES = [("model.embed_tokens.weight", "tok_embeddings.weight"),
              ("model.norm.weight", "norm.weight"), ("lm_head.weight", "output.weight")]
LAYER_NAMES = [("self_attn.q_proj", "attention.wq"), ("self_attn.k_proj", "attention.wk"),
               ("self_attn.v_proj", "attention.wv"), ("self_attn.o_proj", "attention.wo"),
               ("mlp.gate_proj", "feed_forward.w1"), ("mlp.down_proj", "feed_forward.w2"),
               ("mlp.up_proj", "feed_forward.w3"), ("input_layernorm", "attention_norm"),
               ("post_attention_layernorm", "ffn_norm")]


def write_meta_checkpoint(dest: Path, tie: bool) -> None:
    """The fixture's weights under Meta names, q/k in Meta's layout; with
    ``tie`` no output.weight (the loader aliases the embedding)."""
    cfg = load_config(FIXTURE / "config.json")
    doc = open_safetensors(FIXTURE)
    names = dict(META_NAMES)
    for i in range(cfg.num_layers):
        for hf, meta in LAYER_NAMES:
            names[f"model.layers.{i}.{hf}.weight"] = f"layers.{i}.{meta}.weight"
    out = {}
    for name in doc.keys():
        t = doc.torch_tensor(name)
        if ".q_proj." in name:
            t = hf_to_meta(t, cfg.num_heads)
        elif ".k_proj." in name:
            t = hf_to_meta(t, cfg.num_kv_heads)
        if tie and name == "lm_head.weight":
            continue
        out[names[name]] = t
    dest.mkdir()
    save_safetensors(dest / "model.safetensors", out)


def assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
        return
    want = torch.from_numpy(np.ascontiguousarray(want)) if isinstance(want, np.ndarray) \
        else want
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("tie", [False, True])
def test_meta_checkpoint_loads_like_the_hf_one(tmp_path, tie):
    """``source="meta"`` on the renamed, re-permuted fixture: the HF
    checkout's params (with a tied config, its lm_head is the embedding),
    and the JAX package's ``load_params(source="meta")``."""
    meta = tmp_path / "meta"
    write_meta_checkpoint(meta, tie)
    cfg = load_config(FIXTURE / "config.json")
    if tie:
        cfg = cfg.replace(tie_word_embeddings=True)
    kw = dict(dtype=torch.float32, max_seq_len=128, device="cpu")
    got = load_params(open_safetensors(meta), cfg, source="meta", **kw)
    want = load_params(open_safetensors(FIXTURE), cfg, **kw)
    if tie:
        want["lm_head"] = want["embed"].T.contiguous()
    assert_trees_equal(got, want)

    jcfg = jload_config(FIXTURE / "config.json")
    if tie:
        jcfg = jcfg.replace(tie_word_embeddings=True)
    jp = jload_params(jopen(meta), jcfg, dtype=jnp.float32, source="meta", max_seq_len=128)
    # Every loaded weight; the rope tables are computed, not loaded, and
    # each package rounds its own (tests/test_torch_model.py holds them).
    got.pop("rope")
    jp = jax_tree_to_numpy(jp)
    jp.pop("rope")
    assert_trees_equal(got, jp)


def test_rename_and_alias():
    """The document's surgery: regex renames with backreferences, a collision
    raises, an alias reads its source and is listed, ``alias_if_missing``
    leaves a present name alone."""
    doc = open_safetensors(FIXTURE)
    emb = doc.torch_tensor("model.embed_tokens.weight")
    doc.rename(r"^model\.layers\.(\d+)\.", r"blk.\1.")
    assert "blk.0.self_attn.q_proj.weight" in doc and "model.layers.0.mlp.up_proj.weight" \
        not in doc
    with pytest.raises(ValueError, match="collision"):
        doc.rename(r"^blk\.\d+\.", "blk.")
    doc.alias_if_missing("tied.weight", "model.embed_tokens.weight")
    assert "tied.weight" in doc and "tied.weight" in list(doc.keys())
    assert torch.equal(doc.torch_tensor("tied.weight"), emb)
    doc.alias_if_missing("lm_head.weight", "model.embed_tokens.weight")
    assert not torch.equal(doc.torch_tensor("lm_head.weight"), emb)
    with pytest.raises(KeyError):
        doc.alias("x", "missing")


def test_retrieve_config_from_params_json(tmp_path):
    """A checkout with only a Meta ``params.json``: the JAX package's config;
    with a ``config.json`` beside it, the HF one wins in both."""
    (tmp_path / "params.json").write_text(json.dumps(PARAMS["llama-3.2-1b"]))
    want = JFilesystemRepository(tmp_path).retrieve_config()
    assert fields(FilesystemRepository(tmp_path).retrieve_config()) == fields(want)
    shutil.copy(FIXTURE / "config.json", tmp_path / "config.json")
    assert fields(FilesystemRepository(tmp_path).retrieve_config()) == fields(
        JFilesystemRepository(tmp_path).retrieve_config())
    assert FilesystemRepository(tmp_path).retrieve_config().hidden_size == 384
