"""Tokenizer interface, token kinds and streaming decode (port of the JAX
package's ``text/tokenizer.py``).

`TokenKind` is the bitmask of special-token roles, `SpecialTokenRegistry`
the control-token table a tokenizer carries (the chat interpreter reads its
stop ids from it), `StreamingDecoder` the incremental UTF-8 decoder that
renders multi-byte characters split across tokens one token at a time.
"""

from __future__ import annotations

import codecs
import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Protocol, Sequence


class TokenKind(enum.IntFlag):
    """Bitmask of special-token roles."""

    NONE = 0
    BEGIN_TEXT = 1 << 0
    END_TEXT = 1 << 1
    BEGIN_HEADER = 1 << 2
    END_HEADER = 1 << 3
    END_TURN = 1 << 4
    END_MESSAGE = 1 << 5
    IPYTHON = 1 << 6
    PAD = 1 << 7
    UNKNOWN = 1 << 8
    RESERVED = 1 << 9
    CONTROL = 1 << 10


@dataclass(frozen=True)
class SpecialToken:
    text: str
    id: int
    kind: TokenKind = TokenKind.CONTROL


class Tokenizer(Protocol):
    """Minimal tokenizer protocol every backend implements."""

    def encode(self, text: str, *, allow_special: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def token_bytes(self, token_id: int) -> bytes: ...

    @property
    def vocab_size(self) -> int: ...


@dataclass
class SpecialTokenRegistry:
    """Control tokens by text, with their ids and kinds."""

    tokens: Dict[str, SpecialToken] = field(default_factory=dict)

    def add(self, text: str, id: int, kind: TokenKind = TokenKind.CONTROL) -> None:
        self.tokens[text] = SpecialToken(text, id, kind)

    def __contains__(self, text: str) -> bool:
        return text in self.tokens

    def id_of(self, text: str) -> int:
        return self.tokens[text].id

    def by_id(self, token_id: int) -> Optional[SpecialToken]:
        for t in self.tokens.values():
            if t.id == token_id:
                return t
        return None

    def ids_with_kind(self, kind: TokenKind) -> List[int]:
        return [t.id for t in self.tokens.values() if t.kind & kind]

    def items(self):
        return self.tokens.items()


class StreamingDecoder:
    """Incremental token→text decoder: buffers partial UTF-8 sequences so
    multi-byte characters split across tokens render correctly, one `feed`
    per generated token."""

    def __init__(self, tokenizer: Tokenizer):
        self._tokenizer = tokenizer
        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, token_id: int) -> str:
        try:
            raw = self._tokenizer.token_bytes(token_id)
        except ValueError:
            raw = "\ufffd".encode("utf-8")  # out-of-vocab id: never crash
        return self._decoder.decode(raw)

    def flush(self) -> str:
        return self._decoder.decode(b"", final=True)


def decode_stream(tokenizer: Tokenizer, ids: Iterable[int]) -> Iterable[str]:
    """Yield text chunks for a stream of token ids."""
    dec = StreamingDecoder(tokenizer)
    for tid in ids:
        chunk = dec.feed(tid)
        if chunk:
            yield chunk
    tail = dec.flush()
    if tail:
        yield tail
