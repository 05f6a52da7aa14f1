"""Pre-tokenization without the ``regex`` package.

The JAX package splits text before byte-pair merging with ``regex``
patterns that use Unicode property classes (``\\p{L}``, ``\\p{N}``) and a
negative lookahead, which the standard library's ``re`` lacks. This module
is a hand-written scanner for the two patterns the tokenizers use, the
Llama-3 (tiktoken cl100k family) pattern and GPT-2's. At each position it
tries the pattern's alternatives in order and takes the first that matches,
with the backtracking each one implies, exactly as ``regex.findall`` does:

Llama-3: ``(?i:'s|'t|'re|'ve|'m|'ll|'d)`` · ``[^\\r\\n\\p{L}\\p{N}]?\\p{L}+`` ·
``\\p{N}{1,3}`` · `` ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*`` · ``\\s*[\\r\\n]+`` ·
``\\s+(?!\\S)`` · ``\\s+``.

GPT-2: ``'s|'t|'re|'ve|'m|'ll|'d`` · `` ?\\p{L}+`` · `` ?\\p{N}+`` ·
`` ?[^\\s\\p{L}\\p{N}]+`` · ``\\s+(?!\\S)`` · ``\\s+``.

Every character matches one alternative, so the pieces concatenate to the
text. ``\\p{L}`` and ``\\p{N}`` are the general categories ``L*`` and ``N*``
of the standard library's ``unicodedata`` (Unicode 15.0 on Python 3.12);
``\\s`` is the White_Space property, as in ``regex`` (so U+001C-U+001F,
which ``str.isspace`` counts, are not whitespace here). A code point
assigned after the Unicode version of ``unicodedata`` is neither a letter
nor a number here, where a newer ``regex`` may call it one.
"""

from __future__ import annotations

import unicodedata
from typing import Callable, Dict, List

# The split patterns, as the JAX package spells them (its text/bpe.py and
# text/loaders.py); `compile_split` recognizes them by their text.
LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

# Character classes.
OTHER, LETTER, NUMBER, SPACE = 0, 1, 2, 3

# The White_Space property (what ``regex`` matches with ``\s``).
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))

# Contraction suffixes in the order of the alternation, and the characters
# each letter matches under case-insensitive matching (simple case folding:
# U+017F LATIN SMALL LETTER LONG S folds to "s").
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_FOLDS = {"s": "sS\u017f", "t": "tT", "r": "rR", "e": "eE", "v": "vV", "m": "mM",
          "l": "lL", "d": "dD"}

_CLASS_CACHE: Dict[str, int] = {}


def char_class(c: str) -> int:
    """`SPACE`, `LETTER`, `NUMBER` or `OTHER` for one character."""
    k = _CLASS_CACHE.get(c)
    if k is None:
        if c in WHITE_SPACE:
            k = SPACE
        else:
            major = unicodedata.category(c)[0]
            k = LETTER if major == "L" else NUMBER if major == "N" else OTHER
        _CLASS_CACHE[c] = k
    return k


def _run(cls: List[int], j: int, kind: int, limit: int) -> int:
    """End of the run of ``kind`` from ``j``, at most ``limit``."""
    while j < limit and cls[j] == kind:
        j += 1
    return j


def _contraction(text: str, i: int, fold: bool) -> int:
    """End of the contraction at ``i`` (``'`` then a suffix), or -1."""
    if text[i] != "'":
        return -1
    for suffix in CONTRACTIONS:
        end = i + 1 + len(suffix)
        if end <= len(text) and all(
                (text[i + 1 + m] in _FOLDS[ch]) if fold else text[i + 1 + m] == ch
                for m, ch in enumerate(suffix)):
            return end
    return -1


def _space_alternatives(text: str, cls: List[int], i: int, crlf_first: bool) -> int:
    """The whitespace alternatives at ``i`` (``cls[i] == SPACE``):
    ``\\s*[\\r\\n]+`` (Llama-3 only: up to and including the last CR or LF
    of the whitespace run), then ``\\s+(?!\\S)`` (the run, less its last
    character when a non-space follows), then ``\\s+``."""
    n = len(text)
    j = _run(cls, i, SPACE, n)
    if crlf_first:
        for k in range(j - 1, i - 1, -1):
            if text[k] in "\r\n":
                return k + 1
    if j == n:
        return j
    if j - 1 > i:
        return j - 1
    return j


def _match_llama3(text: str, cls: List[int], i: int) -> int:
    n = len(text)
    end = _contraction(text, i, fold=True)
    if end > 0:
        return end
    c = cls[i]
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if c == LETTER:
        return _run(cls, i, LETTER, n)
    if c != NUMBER and text[i] not in "\r\n" and i + 1 < n and cls[i + 1] == LETTER:
        return _run(cls, i + 1, LETTER, n)
    # \p{N}{1,3}
    if c == NUMBER:
        return _run(cls, i, NUMBER, min(n, i + 3))
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] == OTHER else i
    if cls[j] == OTHER:
        j = _run(cls, j, OTHER, n)
        while j < n and text[j] in "\r\n":
            j += 1
        return j
    return _space_alternatives(text, cls, i, crlf_first=True)


def _match_gpt2(text: str, cls: List[int], i: int) -> int:
    n = len(text)
    end = _contraction(text, i, fold=False)
    if end > 0:
        return end
    # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+' in that order
    for kind in (LETTER, NUMBER, OTHER):
        if cls[i] == kind:
            return _run(cls, i, kind, n)
        if text[i] == " " and i + 1 < n and cls[i + 1] == kind:
            return _run(cls, i + 1, kind, n)
    return _space_alternatives(text, cls, i, crlf_first=False)


def _scanner(match: Callable[[str, List[int], int], int]) -> Callable[[str], List[str]]:
    def findall(text: str) -> List[str]:
        cls = [char_class(c) for c in text]
        pieces, i = [], 0
        while i < len(text):
            j = match(text, cls, i)
            pieces.append(text[i:j])
            i = j
        return pieces

    return findall


split_llama3 = _scanner(_match_llama3)
split_gpt2 = _scanner(_match_gpt2)

_SCANNERS = {LLAMA3_SPLIT_PATTERN: split_llama3, GPT2_SPLIT_PATTERN: split_gpt2}


def compile_split(pattern: str) -> Callable[[str], List[str]]:
    """The scanner for a split pattern: ``findall(text) → pieces``."""
    try:
        return _SCANNERS[pattern]
    except KeyError:
        raise NotImplementedError(
            f"no pre-tokenization scanner for the split pattern {pattern!r}: this "
            "package scans the Llama-3 and GPT-2 patterns without the regex "
            "package") from None
