"""Training data: document packing and batching, numpy on the host (the
JAX package's ``train/data.py``, copied: the same seed gives the same
windows, masks and batch order).

Documents are tokenized on the host, packed contiguously into fixed-length
windows separated by EOS, and yielded as {"tokens" [B, S+1], "loss_mask"
[B, S]} batches that `train.step.causal_lm_loss` takes (as numpy arrays;
the step moves them to the parameters' device). Padding in the final
window is masked out of the loss.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class PackedDataset:
    """Pack token documents into fixed-length training windows."""

    def __init__(
        self,
        documents: Iterable[Sequence[int]],
        seq_len: int,
        eos_id: int,
        pad_id: Optional[int] = None,
    ):
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id

        stream: List[int] = []
        for doc in documents:
            stream.extend(int(t) for t in doc)
            stream.append(eos_id)

        window = seq_len + 1  # inputs + shifted labels share the window
        n_full = len(stream) // window
        remainder = len(stream) - n_full * window
        rows = []
        masks = []
        for i in range(n_full):
            rows.append(stream[i * window:(i + 1) * window])
            masks.append([1.0] * seq_len)
        if remainder > 1:  # at least one (input, label) pair
            tail = stream[n_full * window:] + [self.pad_id] * (window - remainder)
            rows.append(tail)
            masks.append([1.0] * (remainder - 1) + [0.0] * (seq_len - remainder + 1))
        self.tokens = np.asarray(rows, np.int32).reshape(-1, window)
        self.loss_mask = np.asarray(masks, np.float32).reshape(-1, seq_len)

    def __len__(self) -> int:
        return len(self.tokens)

    def batches(
        self,
        batch_size: int,
        *,
        seed: Optional[int] = 0,
        epochs: int = 1,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield shuffled {"tokens", "loss_mask"} batches (static shapes)."""
        n = len(self.tokens)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n) if seed is not None else np.arange(n)
            stop = n - n % batch_size if drop_last else n
            for i in range(0, stop, batch_size):
                idx = order[i:i + batch_size]
                if len(idx) < batch_size:
                    # right-pad the final batch with repeated rows, fully
                    # masked so they contribute nothing to the loss.
                    extra = np.zeros(batch_size - len(idx), np.int64)
                    tokens = self.tokens[np.concatenate([idx, extra])]
                    mask = self.loss_mask[np.concatenate([idx, extra])].copy()
                    mask[len(idx):] = 0.0
                    yield {"tokens": tokens, "loss_mask": mask}
                else:
                    yield {"tokens": self.tokens[idx],
                           "loss_mask": self.loss_mask[idx]}


def from_texts(tokenizer, texts: Iterable[str], seq_len: int,
               eos_id: Optional[int] = None) -> PackedDataset:
    """Tokenize raw strings with any framework tokenizer → PackedDataset."""
    if eos_id is None:
        eos_id = getattr(tokenizer, "eos_id", 0)
    docs = [tokenizer.encode(t) for t in texts]
    return PackedDataset(docs, seq_len=seq_len, eos_id=eos_id)
