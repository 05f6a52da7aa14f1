"""Tokenization: the tokenizer protocol and streaming decode, the
pre-tokenization scanner, byte-pair and SentencePiece encoders and their
loaders (no ``regex`` package)."""

from metalchat_tpu_torch.text.bpe import BytePairEncoder  # noqa: F401
from metalchat_tpu_torch.text.gpt2 import bytes_to_unicode, gpt2_decode, gpt2_encode  # noqa: F401
from metalchat_tpu_torch.text.loaders import (  # noqa: F401
    load_gpt2_vocab,
    load_hf_tokenizer_json,
    load_tiktoken_model,
    load_tokenizer,
    llama3_special_tokens,
)
from metalchat_tpu_torch.text.sentencepiece import SentencePieceTokenizer  # noqa: F401
from metalchat_tpu_torch.text.tokenizer import (  # noqa: F401
    SpecialToken,
    SpecialTokenRegistry,
    StreamingDecoder,
    TokenKind,
    Tokenizer,
)
