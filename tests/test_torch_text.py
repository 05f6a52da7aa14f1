"""The port's text layer (metalchat_tpu_torch/text/) against the JAX
package's and its oracles, on the CPU.

* The pre-tokenization scanner against ``regex.findall`` with the JAX
  package's own patterns: hypothesis text drawn from letters, numbers,
  marks, punctuation, whitespace, CR/LF runs and contractions, and the JAX
  tests' corpora; the character classes over every code point. Code points
  unassigned in the standard library's Unicode (15.0) are left out of the
  drawn text: a newer ``regex`` calls some of them letters or numbers
  (ROADMAP.md, Queue C).
* Token ids of every loader identical to the JAX package's (and to
  ``tiktoken`` / ``tokenizers``) on ``tests/test_text.py``'s artifacts and
  the trained fixture's ``tokenizer.model``; decode round trips, the
  streaming decoder on multi-byte splits, ``load_tokenizer`` dispatch.
"""

import base64
import json
import unicodedata
from pathlib import Path

import pytest
import regex
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from metalchat_tpu.text import bpe as jbpe
from metalchat_tpu.text import loaders as jloaders
from metalchat_tpu.text.sentencepiece import SentencePieceTokenizer as JSentencePiece
from metalchat_tpu_torch.text import (
    BytePairEncoder,
    SentencePieceTokenizer,
    StreamingDecoder,
    TokenKind,
    bytes_to_unicode,
    gpt2_decode,
    gpt2_encode,
    llama3_special_tokens,
    load_gpt2_vocab,
    load_hf_tokenizer_json,
    load_tiktoken_model,
    load_tokenizer,
)
from metalchat_tpu_torch.text import pretokenize as pt
from metalchat_tpu_torch.text.tokenizer import decode_stream

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"

# tests/test_text.py's corpus, and more.
SAMPLES = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "  leading and   trailing spaces  ",
    "tabs\tand\nnewlines\r\n\r\n",
    "numbers 123 4567 89, punct!!! ...",
    "unicode: héllo wörld — ¿qué? 你好世界 🦜🌴",
    "code: def f(x): return x**2  # comment",
    "don't can't won't it's I'll you're we've",
    "",
    "DON'T I'LL WE'VE ſ 'S 'ſ ''s 'd'm",
    "x\x1c\x1dy \x1f \x85 \u3000 \u2028z",
    " \n\n  \r\n \t x\n",
    "١٢٣٤ ⅷ ½ 12345678",
    "combining: e\u0301 a\u0308\u0308",
]


def test_split_patterns_are_the_jax_packages():
    assert pt.LLAMA3_SPLIT_PATTERN == jbpe.LLAMA3_SPLIT_PATTERN
    assert pt.GPT2_SPLIT_PATTERN == jloaders.GPT2_SPLIT_PATTERN


@pytest.mark.parametrize("name", ["llama3", "gpt2"])
def test_scanner_matches_regex_on_corpus(name):
    pattern = regex.compile(getattr(pt, f"{name.upper()}_SPLIT_PATTERN"))
    scan = getattr(pt, f"split_{name}")
    for text in SAMPLES:
        assert scan(text) == pattern.findall(text), text
        assert "".join(scan(text)) == text


def _assigned(c: str) -> bool:
    return unicodedata.category(c) != "Cn"


FRAGMENTS = st.sampled_from([
    "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'LL", "'Re", "'ſ", "'",
    " ", "  ", "\t", "\n", "\r\n", "\r", "\n\n", " \n ", "\x0b", "\x1c", "\x85",
    "\xa0", "\u3000", "\u2028", "1", "12", "1234", "٣", "½", "ⅷ", "a", "Z", "é",
    "你", "ß", "\u0301", "!", "...", "—", "🦜", "_", "-", "$",
])
CHARS = st.characters(
    categories=["L", "M", "N", "P", "S", "Z", "Cc"]).filter(_assigned)
TEXT = st.lists(st.one_of(FRAGMENTS, CHARS), max_size=40).map("".join)


@pytest.mark.parametrize("name", ["llama3", "gpt2"])
@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=TEXT)
def test_scanner_matches_regex(name, text):
    pattern = regex.compile(getattr(pt, f"{name.upper()}_SPLIT_PATTERN"))
    assert getattr(pt, f"split_{name}")(text) == pattern.findall(text)


def test_character_classes_over_every_code_point():
    """``\\s`` is regex's White_Space; the case-insensitive contraction
    letters are regex's; ``\\p{L}`` / ``\\p{N}`` agree except on code
    points unassigned in the standard library's Unicode."""
    every = "".join(chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF)
    assert set(regex.findall(r"\s", every)) == pt.WHITE_SPACE
    for letter in "strvemld":
        assert set(regex.findall(f"(?i:{letter})", every)) == set(pt._FOLDS[letter])
    for prop, kind in (("L", pt.LETTER), ("N", pt.NUMBER)):
        theirs = set(regex.findall(rf"\p{{{prop}}}", every))
        ours = {c for c in every if pt.char_class(c) == kind}
        assert ours <= theirs
        assert all(not _assigned(c) for c in theirs - ours)


def test_unknown_split_pattern_raises():
    with pytest.raises(NotImplementedError, match=r"\\p\{L\}\+\|x"):
        pt.compile_split(r"\p{L}+|x")
    with pytest.raises(NotImplementedError, match="split pattern"):
        BytePairEncoder({b"a": 0}, split_pattern=r"\w+")


def test_gpt2_codec():
    table = bytes_to_unicode()
    assert len(set(table.values())) == 256
    for raw in [b"hello", bytes(range(256)), "héllo🦜".encode()]:
        assert gpt2_decode(gpt2_encode(raw)) == raw
    from metalchat_tpu.text import gpt2 as jgpt2

    assert table == jgpt2.bytes_to_unicode()


# -- the artifacts of tests/test_text.py, loaded by both packages -------------

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """tokenizer.json trained by HF ``tokenizers`` (Llama-3 split), a tiny
    tiktoken ``tokenizer.model`` with its ``tiktoken.Encoding``, and a GPT-2
    ``vocab.json`` + ``merges.txt`` with its ``tokenizers`` oracle."""
    import tiktoken
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    root = tmp_path_factory.mktemp("text")
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(pattern=Regex(pt.LLAMA3_SPLIT_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<|begin_of_text|>", "<|eot_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(SAMPLES * 20 + ["the quick brown fox " * 50,
                                            "hello world " * 50], trainer)
    tok.save(str(root / "tokenizer.json"))

    words = ["he", "ll", "o", "hell", "hello", " w", "or", "ld", " wor", " world",
             "th", "e", " the", "qu", "ick", " qu", " quick"]
    ranks = {bytes([b]): b for b in range(256)}
    for i, w in enumerate(words):
        ranks[w.encode()] = 256 + i
    enc = tiktoken.Encoding(name="tiny", pat_str=pt.LLAMA3_SPLIT_PATTERN,
                            mergeable_ranks=ranks,
                            special_tokens={"<|eot|>": 256 + len(words)})
    (root / "tokenizer.model").write_text(
        "\n".join(f"{base64.b64encode(t).decode()} {r}" for t, r in ranks.items()))

    gdir = root / "gpt2"
    gdir.mkdir()
    vocab = {gpt2_encode(bytes([b])): b for b in range(256)}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w")]
    for left, right in merges:
        vocab[left + right] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (gdir / "vocab.json").write_text(json.dumps(vocab))
    (gdir / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{l} {r}" for l, r in merges))
    oracle = Tokenizer(models.BPE.from_file(str(gdir / "vocab.json"),
                                            str(gdir / "merges.txt")))
    oracle.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    return {"hf": (root / "tokenizer.json", tok), "tiktoken": (root / "tokenizer.model", enc),
            "gpt2": (gdir, oracle)}


TEXTS = SAMPLES + ["hello world the quick", "<|begin_of_text|>hi<|eot_id|>",
                   "<|eot|> hello<|eot|>", "he llo  spaces  x", "<|endoftext|>hello"]


def _same(ours, theirs, texts=TEXTS):
    for text in texts:
        for allow in (False, True):
            got = ours.encode(text, allow_special=allow)
            assert got == theirs.encode(text, allow_special=allow), (text, allow)
            assert ours.decode(got) == theirs.decode(got)
    assert ours.vocab_size == theirs.vocab_size


def test_hf_tokenizer_json_identical(artifacts):
    path, oracle = artifacts["hf"]
    ours, theirs = load_hf_tokenizer_json(path), jloaders.load_hf_tokenizer_json(path)
    _same(ours, theirs)
    for text in SAMPLES:
        assert ours.encode(text) == oracle.encode(text, add_special_tokens=False).ids
    ids = ours.encode("<|begin_of_text|>hi<|eot_id|>", allow_special=True)
    assert ids[0] == ours.specials.id_of("<|begin_of_text|>")
    assert ids[-1] == ours.specials.id_of("<|eot_id|>")


def test_tiktoken_model_identical(artifacts):
    path, enc = artifacts["tiktoken"]
    ours = load_tiktoken_model(path, special_tokens=["<|eot|>"])
    _same(ours, jloaders.load_tiktoken_model(path, special_tokens=["<|eot|>"]))
    for text in SAMPLES + ["hello world the quick"]:
        assert ours.encode(text) == enc.encode_ordinary(text)
        assert ours.decode(ours.encode(text)) == text
    # The default specials: Llama-3's 256 from the number of distinct ranks.
    full, jfull = load_tiktoken_model(path), jloaders.load_tiktoken_model(path)
    assert {t: (s.id, int(s.kind)) for t, s in full.specials.items()} == {
        t: (s.id, int(s.kind)) for t, s in jfull.specials.items()}
    assert full.specials.id_of("<|eot_id|>") == full.specials.id_of("<|begin_of_text|>") + 9
    assert full.specials.tokens["<|eot_id|>"].kind == TokenKind.END_TURN
    _same(full, jfull)


def test_gpt2_vocab_identical(artifacts):
    gdir, oracle = artifacts["gpt2"]
    ours = load_gpt2_vocab(gdir / "vocab.json", gdir / "merges.txt")
    _same(ours, jloaders.load_gpt2_vocab(gdir / "vocab.json", gdir / "merges.txt"))
    for text in ["hello world", "he llo", "x", "  spaces  ", "héllo"]:
        assert ours.encode(text) == oracle.encode(text).ids, text
    assert ours.specials.tokens["<|endoftext|>"].kind == TokenKind.END_TEXT


def test_fixture_tokenizer_identical():
    """The trained fixture's byte ``tokenizer.model``: 256 ranks, Llama-3's
    specials at 256-511."""
    ours = load_tiktoken_model(FIXTURE / "tokenizer.model")
    theirs = jloaders.load_tiktoken_model(FIXTURE / "tokenizer.model")
    _same(ours, theirs, TEXTS + ["def main():\n    ", "<|start_header_id|>user<|end_header_id|>"])
    assert ours.encode("def main():\n    ") == list(b"def main():\n    ")
    assert ours.specials.id_of("<|begin_of_text|>") == 256
    assert ours.specials.id_of("<|reserved_special_token_247|>") == 511
    assert llama3_special_tokens() == jloaders.llama3_special_tokens()


def _sentencepiece_parts():
    pieces = ["▁the", "▁quick", "▁fox", "th", "qu", "ick", "▁", "t", "h", "e",
              "q", "u", "i", "c", "k", "f", "o", "x", "▁t", "he"]
    vocab = {b"<pad>": 0, b"<unk>": 1}
    for b in range(256):
        vocab[b"<0x%02X>" % b] = 2 + b
    for i, p in enumerate(pieces):
        vocab[p.encode()] = 258 + i
    merges = {(b"\xe2\x96\x81", b"the"): 0, (b"t", b"h"): 1, (b"th", b"e"): 2,
              (b"\xe2\x96\x81", b"t"): 3, (b"h", b"e"): 4, (b"q", b"u"): 5,
              (b"i", b"c"): 6, (b"ic", b"k"): 7, (b"qu", b"ick"): 8,
              (b"\xe2\x96\x81", b"quick"): 9}
    for extra in ["the", "ic", "ick", "quick", "▁quick", "▁the"]:
        vocab.setdefault(extra.encode(), len(vocab) + 300)
    return vocab, merges


@pytest.mark.parametrize("dummy_prefix", [False, True])
def test_sentencepiece_identical(dummy_prefix):
    vocab, merges = _sentencepiece_parts()
    ours = SentencePieceTokenizer(dict(vocab), dict(merges), add_dummy_prefix=dummy_prefix)
    theirs = JSentencePiece(dict(vocab), dict(merges), add_dummy_prefix=dummy_prefix)
    for tok in (ours, theirs):
        tok.add_special("<start_of_turn>", 900, TokenKind.BEGIN_HEADER)
    _same(ours, theirs, TEXTS + ["the quick fox", "Z é", "<start_of_turn>the quick"])
    assert ours.decode(ours.encode("the quick")).strip() == "the quick"
    if not dummy_prefix:
        assert ours.encode("Z") == [2 + 0x5A]  # byte fallback
    assert ours.decode(ours.encode("é")).strip() == "é"


def test_streaming_decoder_splits_multibyte(artifacts):
    path, _ = artifacts["tiktoken"]
    ours = load_tiktoken_model(path, special_tokens=[])
    ids = ours.encode("🦜é")  # 4 + 2 single-byte tokens
    assert len(ids) == 6
    dec = StreamingDecoder(ours)
    chunks = [dec.feed(t) for t in ids]
    assert chunks == ["", "", "", "🦜", "", "é"] and dec.flush() == ""
    assert "".join(decode_stream(ours, ids)) == "🦜é"
    # An id outside the vocabulary renders as U+FFFD, in both decoders.
    assert StreamingDecoder(ours).feed(10 ** 6) == "\ufffd"
    assert ours.decode([104, 10 ** 6]) == "h\ufffd"


def test_load_tokenizer_dispatch(tmp_path, artifacts):
    path, _ = artifacts["tiktoken"]
    (tmp_path / "tokenizer.model").write_text(path.read_text())
    assert load_tokenizer(tmp_path).encode("hello") == [256 + 4]
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    (hf_dir / "tokenizer.json").write_text(artifacts["hf"][0].read_text())
    (hf_dir / "tokenizer.model").write_text(path.read_text())  # tokenizer.json wins
    assert load_tokenizer(hf_dir).encode("hello") == load_hf_tokenizer_json(
        artifacts["hf"][0]).encode("hello")
    gdir, _ = artifacts["gpt2"]
    assert load_tokenizer(gdir).encode("hello") == [259]
    with pytest.raises(FileNotFoundError):
        load_tokenizer(tmp_path / "nope")
