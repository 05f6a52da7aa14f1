"""SentencePiece-style tokenizer (port of the JAX package's
``text/sentencepiece.py``): char-unit BPE over raw unicode with
"▁"-encoded whitespace and ``<0xNN>`` byte fallback, used by the Gemma
family."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from metalchat_tpu_torch.text.bpe import BytePairEncoder
from metalchat_tpu_torch.text.tokenizer import SpecialTokenRegistry

WHITESPACE = "\u2581"  # LOWER ONE EIGHTH BLOCK


class SentencePieceTokenizer:
    """Char-unit BPE with ▁ whitespace and <0xNN> byte fallback."""

    def __init__(
        self,
        vocab: Dict[bytes, int],
        merges: Optional[Dict[Tuple[bytes, bytes], int]] = None,
        *,
        specials: Optional[SpecialTokenRegistry] = None,
        add_dummy_prefix: bool = False,
    ):
        self._bpe = BytePairEncoder(
            vocab,
            merges=merges,
            split_pattern=None,
            specials=specials,
            unit="char",
            byte_fallback=True,
        )
        self._add_dummy_prefix = add_dummy_prefix

    @property
    def specials(self) -> SpecialTokenRegistry:
        return self._bpe.specials

    @property
    def vocab_size(self) -> int:
        return self._bpe.vocab_size

    def add_special(self, *a, **kw) -> None:
        self._bpe.add_special(*a, **kw)

    def _normalize(self, text: str) -> str:
        if self._add_dummy_prefix and text and not text.startswith(" "):
            text = " " + text
        return text.replace(" ", WHITESPACE)

    def encode(self, text: str, *, allow_special: bool = False) -> List[int]:
        if allow_special and self._bpe._special_split is not None:
            ids: List[int] = []
            for seg in self._bpe._special_split.split(text):
                if not seg:
                    continue
                if seg in self._bpe.specials:
                    ids.append(self._bpe.specials.id_of(seg))
                else:
                    ids.extend(self._bpe.encode_piece(self._normalize(seg).encode("utf-8")))
            return ids
        return self._bpe.encode_piece(self._normalize(text).encode("utf-8")) if text else []

    def token_bytes(self, token_id: int) -> bytes:
        raw = self._bpe.token_bytes(token_id)
        return raw.replace(WHITESPACE.encode("utf-8"), b" ")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        rep = "\ufffd".encode("utf-8")
        out = []
        for t in ids:
            try:
                out.append(self.token_bytes(t))
            except ValueError:
                out.append(rep)
        return b"".join(out)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", "replace")
