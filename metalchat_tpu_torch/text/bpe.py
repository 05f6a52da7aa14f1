"""Byte-pair encoding core (port of the JAX package's ``text/bpe.py``).

Pre-split with the hand-written scanner of `text.pretokenize` (the JAX
package uses the ``regex`` package), dictionary hit or byte-pair merge by
rank, control-token registry and its split (the standard library's ``re``
over the escaped token texts).

Two rank modes:
  * tiktoken: a merge is legal iff the concatenation exists in the vocab, and
    its rank IS its vocab id (lower id merges first).
  * explicit: HF ``merges`` list gives the rank table (Llama-3 / Gemma
    tokenizer.json).

Two unit modes:
  * ``byte``: initial symbols are single bytes (GPT/Llama byte-level BPE).
  * ``char``: initial symbols are unicode characters (SentencePiece-style),
    with ``<0xNN>`` byte fallback.

In tiktoken-rank byte mode the merge runs in the native library
(`metalchat_tpu_torch.native.NativeBPE`, as the JAX package's does);
explicit-merge and char-unit modes keep the Python loop. `_merge` stays as
the plain version the tests hold the library to.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from metalchat_tpu_torch.native import NativeBPE
from metalchat_tpu_torch.text.pretokenize import LLAMA3_SPLIT_PATTERN, compile_split
from metalchat_tpu_torch.text.tokenizer import SpecialTokenRegistry, TokenKind


class BytePairEncoder:
    """Greedy lowest-rank-first BPE over bytes or unicode chars."""

    def __init__(
        self,
        vocab: Dict[bytes, int],
        *,
        merges: Optional[Dict[Tuple[bytes, bytes], int]] = None,
        split_pattern: Optional[str] = LLAMA3_SPLIT_PATTERN,
        specials: Optional[SpecialTokenRegistry] = None,
        unit: str = "byte",
        byte_fallback: bool = False,
    ):
        if unit not in ("byte", "char"):
            raise ValueError(f"unit must be 'byte' or 'char', got {unit!r}")
        self._vocab = vocab
        self._merges = merges
        self._unit = unit
        self._byte_fallback = byte_fallback
        self._split = compile_split(split_pattern) if split_pattern else None
        self.specials = specials or SpecialTokenRegistry()
        self._special_split = None
        self._rebuild_special_split()
        # The native merge loop in tiktoken-rank byte mode (the JAX
        # package's rule); it raises if the library cannot be built.
        self._native = NativeBPE(vocab) if merges is None and unit == "byte" else None

        self._id_to_bytes: Dict[int, bytes] = {}
        for tok, tid in vocab.items():
            self._id_to_bytes.setdefault(tid, tok)
        # Byte-fallback tokens decode to their raw byte.
        if byte_fallback:
            for b in range(256):
                fid = vocab.get(b"<0x%02X>" % b)
                if fid is not None:
                    self._id_to_bytes[fid] = bytes([b])

    def _rebuild_special_split(self) -> None:
        texts = sorted(self.specials.tokens, key=len, reverse=True)
        if texts:
            pat = "|".join(re.escape(t) for t in texts)
            self._special_split = re.compile(f"({pat})")
        else:
            self._special_split = None

    def add_special(self, text: str, id: int, kind: TokenKind = TokenKind.CONTROL) -> None:
        self.specials.add(text, id, kind)
        self._id_to_bytes[id] = text.encode("utf-8")
        self._rebuild_special_split()

    # -- encoding ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        n = max(self._vocab.values(), default=-1)
        m = max((t.id for t in self.specials.tokens.values()), default=-1)
        return max(n, m) + 1

    def _rank(self, left: bytes, right: bytes) -> Optional[int]:
        if self._merges is not None:
            return self._merges.get((left, right))
        return self._vocab.get(left + right)  # tiktoken: rank == vocab id

    def _initial_symbols(self, piece: bytes) -> List[bytes]:
        if self._unit == "byte":
            return [piece[i : i + 1] for i in range(len(piece))]
        return [c.encode("utf-8") for c in piece.decode("utf-8", "surrogateescape")]

    def _merge(self, piece: bytes) -> List[bytes]:
        parts = self._initial_symbols(piece)
        while len(parts) > 1:
            best_rank: Optional[int] = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._rank(parts[i], parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = parts[best_i] + parts[best_i + 1]
            if self._merges is not None and merged not in self._vocab:
                # Rank table references a token absent from the vocab; stop
                # merging this pair to avoid an unencodable symbol.
                del self._merges[(parts[best_i], parts[best_i + 1])]
                continue
            parts[best_i : best_i + 2] = [merged]
        return parts

    def _symbol_ids(self, sym: bytes, out: List[int]) -> None:
        tid = self._vocab.get(sym)
        if tid is not None:
            out.append(tid)
            return
        if self._byte_fallback:
            for b in sym:
                fid = self._vocab.get(b"<0x%02X>" % b)
                if fid is None:
                    raise ValueError(f"no byte-fallback token for 0x{b:02X}")
                out.append(fid)
            return
        raise ValueError(f"unencodable symbol {sym!r}")

    def encode_piece(self, piece: bytes) -> List[int]:
        if self._native is not None:
            ids = self._native.encode_piece(piece)
            if ids is not None:
                return ids
            # A symbol the vocabulary lacks: the JAX package sends this one
            # piece to the Python path below, whose byte-fallback handling
            # gives its ids or raises. That is the reference's semantics,
            # not a way around the library.
        return self.encode_piece_plain(piece)

    def encode_piece_plain(self, piece: bytes) -> List[int]:
        """`encode_piece` through the Python merge loop (`_merge`) alone:
        the plain version the native merge is held to."""
        tid = self._vocab.get(piece)
        if tid is not None:
            return [tid]
        out: List[int] = []
        for sym in self._merge(piece):
            self._symbol_ids(sym, out)
        return out

    def encode_ordinary(self, text: str) -> List[int]:
        """Encode with no special-token interpretation."""
        ids: List[int] = []
        pieces = self._split(text) if self._split else ([text] if text else [])
        for piece in pieces:
            ids.extend(self.encode_piece(piece.encode("utf-8")))
        return ids

    def encode(self, text: str, *, allow_special: bool = False) -> List[int]:
        if not allow_special or self._special_split is None:
            return self.encode_ordinary(text)
        ids: List[int] = []
        for segment in self._special_split.split(text):
            if not segment:
                continue
            if segment in self.specials:
                ids.append(self.specials.id_of(segment))
            else:
                ids.extend(self.encode_ordinary(segment))
        return ids

    # -- decoding ----------------------------------------------------------

    def token_bytes(self, token_id: int) -> bytes:
        try:
            return self._id_to_bytes[token_id]
        except KeyError:
            raise ValueError(f"unknown token id {token_id}") from None

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        """Lenient decode: ids outside the vocab (e.g. a model whose
        vocab_size exceeds the tokenizer's, or reserved ids) render as
        U+FFFD instead of raising: generation must never crash on decode."""
        replacement = "\ufffd".encode("utf-8")
        return b"".join(self._id_to_bytes.get(t, replacement) for t in ids)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", "replace")
