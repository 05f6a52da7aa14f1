"""The port's native host runtime (metalchat_tpu_torch/native: the mmap data
plane and the BPE merge loop, built with g++ at first use) against the JAX
package, on the CPU.

* Documents: every tensor of the trained fixture (tests/fixtures/pyllama_10m)
  read through the port's native mapping equals the JAX package's
  `SafetensorsDocument` array bit for bit, and so does `load_params`' tree
  (the rope tables, computed apart, within 1e-5); a sharded checkpoint opens
  each shard through the library; views stay valid after their document is
  gone (the mapping is never unmapped on garbage collection).
* The merge: the native loop equals the port's Python `_merge` path and the
  JAX package's `BytePairEncoder.encode`, id for id, on hypothesis texts
  over three tiktoken-rank vocabularies: the fixture's byte-level
  tokenizer, a 128,000-rank one in Llama-3's layout
  (`chip_smoke.write_llama3_tokenizer`) and one of the eval corpus's most
  frequent n-grams, whose pieces merge many times over. No tolerance: ids
  are integers.
* A piece the library cannot encode takes the JAX package's byte-fallback
  ids; a failing compiler raises with its output and leaves no library.
"""

import collections
import copy
import gc
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

import chip_smoke
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import SafetensorsDocument as JDocument
from metalchat_tpu.io.safetensors import save_sharded_safetensors as jsave_sharded
from metalchat_tpu.text import bpe as jbpe
from metalchat_tpu.text import loaders as jloaders
from metalchat_tpu_torch import native
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import SafetensorsDocument, open_safetensors
from metalchat_tpu_torch.native import build
from metalchat_tpu_torch.text import BytePairEncoder, load_tiktoken_model
from test_torch_text import TEXT
from torch_port_util import jax_tree_to_numpy

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
CORPUS = np.load(FIXTURE / "eval_tokens.npy")[:200_000].astype(np.uint8).tobytes()


def _raw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# -- documents -----------------------------------------------------------------

def test_fixture_tensors_match_jax_bit_for_bit():
    native.reset_calls()
    doc = SafetensorsDocument.open(FIXTURE / "model.safetensors")
    assert isinstance(doc._owner, native.NativeMmap) and native.CALLS["mmap_open"] == 1
    want = JDocument.open(FIXTURE / "model.safetensors")
    names = sorted(want.keys())
    assert sorted(doc.keys()) == names and len(names) > 50
    for name in names:
        e, w = doc.entry(name), want[name]
        assert e.dtype == want.entry(name).dtype and e.shape == tuple(w.shape)
        got = doc.tensor(name)
        assert not got.flags.writeable  # the pages are mapped read-only
        np.testing.assert_array_equal(_raw(got), _raw(w), err_msg=name)


def test_load_params_through_native_matches_jax():
    jcfg = jload_config(FIXTURE / "config.json")
    want = jax_tree_to_numpy(jload_params(JDocument.open(FIXTURE / "model.safetensors"),
                                          jcfg, dtype=jnp.float32, max_seq_len=128))
    native.reset_calls()
    got = load_params(open_safetensors(FIXTURE), load_config(FIXTURE / "config.json"),
                      dtype=torch.float32, max_seq_len=128, device="cpu")
    assert native.CALLS["mmap_open"] == 1
    for name, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), w)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    for name in ("cos", "sin"):
        np.testing.assert_allclose(got["rope"][name].numpy(), want["rope"][name],
                                   rtol=1e-5, atol=1e-5)


def test_sharded_document_maps_every_shard(tmp_path):
    jdoc = JDocument.open(FIXTURE / "model.safetensors")
    jsave_sharded(tmp_path, {n: jdoc[n] for n in jdoc.keys()}, max_shard_bytes=6 << 20)
    shards = sorted(tmp_path.glob("model-*.safetensors"))
    assert len(shards) == 4
    native.reset_calls()
    doc = open_safetensors(tmp_path)
    assert native.CALLS["mmap_open"] == len(shards)
    for name in jdoc.keys():
        np.testing.assert_array_equal(_raw(doc.tensor(name)), _raw(jdoc[name]))


def test_views_outlive_their_document():
    doc = open_safetensors(FIXTURE)
    view = doc.tensor("model.layers.0.self_attn.q_proj.weight")
    want = view.copy()
    del doc
    gc.collect()
    np.testing.assert_array_equal(view, want)


def test_mmap_header_length_advice_and_errors(tmp_path):
    path = FIXTURE / "model.safetensors"
    blob = path.read_bytes()
    m = native.NativeMmap(path)
    assert m.size == len(blob)
    assert m.header_len == int.from_bytes(blob[:8], "little") > 0
    view = m.view()
    assert bytes(view[:4096]) == blob[:4096] and bytes(view[-64:]) == blob[-64:]
    for advice in ("normal", "willneed", "sequential", "dontneed"):
        m.advise(advice)
        m.advise(advice, offset=8 + m.header_len, length=12345)
    assert bytes(view[-64:]) == blob[-64:]  # DONTNEED on a file mapping re-reads the file
    with pytest.raises(ValueError, match="unknown advice"):
        m.advise("random")
    with pytest.raises(ValueError, match="outside"):
        m.advise("willneed", offset=m.size - 4, length=8)
    del view
    m.close()
    with pytest.raises(ValueError, match="closed"):
        m.size  # noqa: B018
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((200 << 20).to_bytes(8, "little") + b"{}")
    assert native.NativeMmap(bad).header_len == 0  # implausible: past the file
    with pytest.raises(ValueError, match="implausible header length"):
        SafetensorsDocument.open(bad)
    with pytest.raises(OSError):
        native.NativeMmap(tmp_path / "missing.safetensors")
    with pytest.raises(FileNotFoundError):
        open_safetensors(tmp_path / "missing.safetensors")
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(OSError):
        native.NativeMmap(tmp_path / "empty")


# -- the merge loop ------------------------------------------------------------

def _ngram_vocab(n_tokens=6000):
    """The 256 bytes, then the corpus's most frequent 2- to 8-grams ranked
    by count: pieces of source text merge many times over."""
    counts = collections.Counter()
    for n in range(2, 9):
        counts.update(CORPUS[i:i + n] for i in range(0, 60_000 - n))
    vocab = {bytes([b]): b for b in range(256)}
    for tok, _ in counts.most_common():
        if len(vocab) == n_tokens:
            break
        vocab.setdefault(tok, len(vocab))
    return vocab


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """name → (the port's tokenizer, the same with the Python merge only,
    the JAX package's)."""
    tmp = tmp_path_factory.mktemp("native_bpe")
    chip_smoke.write_llama3_tokenizer(tmp / "llama3.model")
    out = {}
    for name, path in (("fixture", FIXTURE / "tokenizer.model"),
                       ("llama3-layout", tmp / "llama3.model")):
        port = load_tiktoken_model(path)
        out[name] = (port, jloaders.load_tiktoken_model(path))
    vocab = _ngram_vocab()
    out["ngram"] = (BytePairEncoder(vocab), jbpe.BytePairEncoder(dict(vocab)))
    result = {}
    for name, (port, jax_tok) in out.items():
        assert port._native is not None
        plain = copy.copy(port)
        plain._native = None
        result[name] = (port, plain, jax_tok)
    return result


CORPUS_SLICES = st.tuples(st.integers(0, len(CORPUS) - 400), st.integers(0, 400)).map(
    lambda t: CORPUS[t[0]:t[0] + t[1]].decode("utf-8", "replace"))


@pytest.mark.parametrize("name", ["fixture", "llama3-layout", "ngram"])
@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=st.one_of(TEXT, CORPUS_SLICES))
def test_native_merge_matches_python_and_jax(tokenizers, name, text):
    port, plain, jax_tok = tokenizers[name]
    before = native.CALLS["encode_piece"]
    got = port.encode(text)
    assert got == plain.encode(text) == jax_tok.encode(text)
    pieces = port._split(text)
    assert native.CALLS["encode_piece"] - before == sum(1 for p in pieces if p)
    for piece in pieces:
        b = piece.encode("utf-8")
        assert port._native.encode_piece(b) == port.encode_piece_plain(b)


def test_corpus_merges_deeply(tokenizers):
    """The n-gram vocabulary's pieces do merge: source text encodes to far
    fewer ids than bytes, identically on all three."""
    port, plain, jax_tok = tokenizers["ngram"]
    text = CORPUS[100_000:120_000].decode("utf-8", "replace")
    got = port.encode(text)
    assert len(got) < 0.6 * len(text.encode("utf-8"))
    assert got == plain.encode(text) == jax_tok.encode(text)


def test_unencodable_piece_takes_jax_byte_fallback():
    vocab = {b"a": 0, b"b": 1, b"ab": 2, b"ba": 3, b" ": 4}
    vocab.update({b"<0x%02X>" % b: 5 + b for b in range(256)})
    port = BytePairEncoder(dict(vocab), byte_fallback=True)
    jax_tok = jbpe.BytePairEncoder(dict(vocab), byte_fallback=True)
    assert port._native.encode_piece(b"abz") is None  # -1 from the library
    for text in ("abz", "ab ba", "zé ab", "\U0001f99c aba"):
        assert port.encode(text) == jax_tok.encode(text), text
    assert port.encode("abz") == [2, 5 + ord("z")]
    strict = BytePairEncoder({b"a": 0, b"b": 1, b"ab": 2})
    with pytest.raises(ValueError, match="unencodable symbol"):
        strict.encode_piece(b"abz")
    with pytest.raises(ValueError, match="unencodable symbol"):
        jbpe.BytePairEncoder({b"a": 0, b"b": 1, b"ab": 2}).encode_piece(b"abz")


def test_python_modes_keep_the_python_loop():
    """Explicit merges (HF tokenizer.json) and char units (SentencePiece)
    keep the Python path, as in the JAX package."""
    vocab = {b"a": 0, b"b": 1, b"ab": 2}
    assert BytePairEncoder(vocab, merges={(b"a", b"b"): 0})._native is None
    assert BytePairEncoder(vocab, unit="char")._native is None


# -- the build -----------------------------------------------------------------

def test_failing_compiler_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-fno-such-option",))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(rc=\d+\)[\s\S]*no-such-option"):
        native.library()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        SafetensorsDocument.open(FIXTURE / "model.safetensors")  # no fallback
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build the native library"):
        native.library()
    assert list(tmp_path.iterdir()) == []


def test_build_is_keyed_by_sources_and_flags(tmp_path, monkeypatch):
    """A new build directory builds the library once, under the hash of the
    sources and flags, and loads it; other flags name another file."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    path = build.library_path()
    assert path.parent == tmp_path and path.name.startswith("libmetalchat_native-")
    lib = native.library()
    assert path.exists() and [p.name for p in tmp_path.iterdir()] == [path.name]
    assert native.library() is lib and build.build() == path
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-g",))
    assert build.library_path() != path
