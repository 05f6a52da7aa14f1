"""Tokenizer loaders (port of the JAX package's ``text/loaders.py``): HF
``tokenizer.json``, Meta tiktoken ``tokenizer.model`` with the Llama-3
control-token layout, and the GPT-2 ``vocab.json`` + ``merges.txt`` pair.

A ``tokenizer.json`` whose pre-tokenizer splits with a pattern other than
the Llama-3 or GPT-2 one raises `NotImplementedError` (`text.pretokenize`).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from metalchat_tpu_torch.text.bpe import BytePairEncoder
from metalchat_tpu_torch.text.gpt2 import gpt2_decode
from metalchat_tpu_torch.text.pretokenize import GPT2_SPLIT_PATTERN, LLAMA3_SPLIT_PATTERN
from metalchat_tpu_torch.text.sentencepiece import SentencePieceTokenizer
from metalchat_tpu_torch.text.tokenizer import SpecialTokenRegistry, TokenKind

AnyTokenizer = Union[BytePairEncoder, SentencePieceTokenizer]

# Role kinds for well-known control tokens (Llama-3 and Gemma families).
_KNOWN_KINDS = {
    "<|begin_of_text|>": TokenKind.BEGIN_TEXT,
    "<|end_of_text|>": TokenKind.END_TEXT,
    "<|start_header_id|>": TokenKind.BEGIN_HEADER,
    "<|end_header_id|>": TokenKind.END_HEADER,
    "<|eot_id|>": TokenKind.END_TURN,
    "<|eom_id|>": TokenKind.END_MESSAGE,
    "<|python_tag|>": TokenKind.IPYTHON,
    "<|finetune_right_pad_id|>": TokenKind.PAD,
    "<bos>": TokenKind.BEGIN_TEXT,
    "<eos>": TokenKind.END_TEXT,
    "<end_of_turn>": TokenKind.END_TURN,
    "<start_of_turn>": TokenKind.BEGIN_HEADER,
    "<pad>": TokenKind.PAD,
    "<unk>": TokenKind.UNKNOWN,
}


def _kind_of(text: str) -> TokenKind:
    kind = _KNOWN_KINDS.get(text)
    if kind is not None:
        return kind
    if "reserved_special" in text or "unused" in text:
        return TokenKind.RESERVED
    return TokenKind.CONTROL


def llama3_special_tokens(base_id: int = 128000) -> List[str]:
    """The Llama-3.1 control-token layout appended after the 128000-word BPE
    vocab (256 names)."""
    named = [
        "<|begin_of_text|>",
        "<|end_of_text|>",
        "<|reserved_special_token_0|>",
        "<|reserved_special_token_1|>",
        "<|finetune_right_pad_id|>",
        "<|reserved_special_token_2|>",
        "<|start_header_id|>",
        "<|end_header_id|>",
        "<|eom_id|>",
        "<|eot_id|>",
        "<|python_tag|>",
    ]
    named += [f"<|reserved_special_token_{i}|>" for i in range(3, 248)]
    return named


def load_tiktoken_model(
    path: str | Path, special_tokens: Optional[List[str]] = None
) -> BytePairEncoder:
    """Load a Meta-format base64 ``tokenizer.model``: one ``<base64> <rank>``
    line a token; the specials follow the ranks."""
    vocab: Dict[bytes, int] = {}
    for line in Path(path).read_text().splitlines():
        if not line:
            continue
        b64, rank = line.split()
        vocab[base64.b64decode(b64)] = int(rank)
    specials = SpecialTokenRegistry()
    names = special_tokens if special_tokens is not None else llama3_special_tokens()
    base = len(vocab)
    for i, name in enumerate(names):
        specials.add(name, base + i, _kind_of(name))
    return BytePairEncoder(
        vocab, split_pattern=LLAMA3_SPLIT_PATTERN, specials=specials
    )


def _hf_merges(raw) -> List[Tuple[str, str]]:
    out = []
    for m in raw:
        if isinstance(m, str):
            left, right = m.split(" ", 1)
        else:
            left, right = m
        out.append((left, right))
    return out


def _find_split_pattern(pre_tokenizer) -> Optional[str]:
    """The Split pattern of a (possibly nested) pre_tokenizer spec."""
    if not pre_tokenizer:
        return None
    kind = pre_tokenizer.get("type")
    if kind == "Sequence":
        for sub in pre_tokenizer.get("pretokenizers", []):
            pat = _find_split_pattern(sub)
            if pat:
                return pat
    if kind == "Split":
        pattern = pre_tokenizer.get("pattern", {})
        return pattern.get("Regex") or pattern.get("String")
    return None


def load_hf_tokenizer_json(path: str | Path) -> AnyTokenizer:
    """Load a HuggingFace ``tokenizer.json``.

    Dispatches on the serialized model: byte-level BPE (Llama-3, GPT) →
    `BytePairEncoder` with the GPT-2 codec-decoded vocab; SentencePiece-style
    BPE with byte fallback (Gemma) → `SentencePieceTokenizer`.
    """
    spec = json.loads(Path(path).read_text())
    model = spec.get("model", {})
    if model.get("type") != "BPE":
        raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")

    byte_fallback = bool(model.get("byte_fallback"))
    specials = SpecialTokenRegistry()
    added = {t["content"]: t for t in spec.get("added_tokens", [])}
    for text, tok in added.items():
        specials.add(text, int(tok["id"]), _kind_of(text))

    raw_vocab: Dict[str, int] = model["vocab"]
    merges = _hf_merges(model.get("merges", []))

    if byte_fallback:
        # SentencePiece-style: token strings are literal unicode (with ▁).
        vocab = {
            tok.encode("utf-8"): tid
            for tok, tid in raw_vocab.items()
            if tok not in added
        }
        ranks = {
            (l.encode("utf-8"), r.encode("utf-8")): i for i, (l, r) in enumerate(merges)
        }
        # Gemma normalizes " " → "▁" with no dummy prefix.
        add_dummy = _normalizer_adds_prefix(spec.get("normalizer"))
        return SentencePieceTokenizer(
            vocab, ranks, specials=specials, add_dummy_prefix=add_dummy
        )

    # Byte-level BPE: vocab/merge strings are GPT-2 codec encoded.
    vocab = {gpt2_decode(tok): tid for tok, tid in raw_vocab.items() if tok not in added}
    ranks = {(gpt2_decode(l), gpt2_decode(r)): i for i, (l, r) in enumerate(merges)}
    split = _find_split_pattern(spec.get("pre_tokenizer")) or LLAMA3_SPLIT_PATTERN
    return BytePairEncoder(
        vocab, merges=ranks or None, split_pattern=split, specials=specials
    )


def _normalizer_adds_prefix(normalizer) -> bool:
    if not normalizer:
        return False
    if normalizer.get("type") == "Prepend":
        return True
    if normalizer.get("type") == "Sequence":
        return any(_normalizer_adds_prefix(n) for n in normalizer.get("normalizers", []))
    return False


def load_gpt2_vocab(
    vocab_path: str | Path, merges_path: str | Path
) -> BytePairEncoder:
    """Load the classic GPT-2 artifact pair: ``vocab.json`` + ``merges.txt``."""
    raw_vocab = json.loads(Path(vocab_path).read_text())
    vocab = {gpt2_decode(tok): tid for tok, tid in raw_vocab.items()}
    ranks: Dict[Tuple[bytes, bytes], int] = {}
    for line in Path(merges_path).read_text().splitlines():
        if not line or line.startswith("#version"):
            continue
        left, right = line.split(" ", 1)
        ranks[(gpt2_decode(left), gpt2_decode(right))] = len(ranks)
    specials = SpecialTokenRegistry()
    if "<|endoftext|>" in raw_vocab:
        specials.add("<|endoftext|>", raw_vocab["<|endoftext|>"], TokenKind.END_TEXT)
        vocab.pop(gpt2_decode("<|endoftext|>"), None)
    return BytePairEncoder(
        vocab, merges=ranks, split_pattern=GPT2_SPLIT_PATTERN, specials=specials
    )


def load_tokenizer(model_dir: str | Path) -> AnyTokenizer:
    """Load whichever tokenizer artifact a model directory provides."""
    model_dir = Path(model_dir)
    hf = model_dir / "tokenizer.json"
    if hf.exists():
        return load_hf_tokenizer_json(hf)
    meta = model_dir / "tokenizer.model"
    if meta.exists():
        return load_tiktoken_model(meta)
    vocab = model_dir / "vocab.json"
    merges = model_dir / "merges.txt"
    if vocab.exists() and merges.exists():
        return load_gpt2_vocab(vocab, merges)
    raise FileNotFoundError(f"no tokenizer artifact under {model_dir}")
