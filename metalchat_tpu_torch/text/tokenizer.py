"""Tokenizer protocol and streaming decode (port of the JAX package's
``text/tokenizer.py``: the protocol the HTTP server needs and the
incremental UTF-8 decoder). The tokenizer implementations are not ported
yet."""

from __future__ import annotations

import codecs
from typing import Iterable, List, Protocol, Sequence


class Tokenizer(Protocol):
    """Minimal tokenizer protocol every backend implements."""

    def encode(self, text: str, *, allow_special: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def token_bytes(self, token_id: int) -> bytes: ...

    @property
    def vocab_size(self) -> int: ...


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
