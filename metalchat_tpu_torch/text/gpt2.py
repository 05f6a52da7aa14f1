"""GPT-2 byte↔printable-unicode bijection (port of the JAX package's
``text/gpt2.py``): HuggingFace BPE vocabularies store token bytes as
printable unicode through this codec."""

from __future__ import annotations

import functools
from typing import Dict


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """The canonical GPT-2 mapping: 256 byte values → printable code points."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    codepoints = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            codepoints.append(256 + n)
            n += 1
    return dict(zip(printable, (chr(c) for c in codepoints)))


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def gpt2_encode(raw: bytes) -> str:
    """bytes → printable-unicode token string."""
    table = bytes_to_unicode()
    return "".join(table[b] for b in raw)


def gpt2_decode(token: str) -> bytes:
    """printable-unicode token string → raw bytes."""
    table = unicode_to_bytes()
    return bytes(table[c] for c in token)
