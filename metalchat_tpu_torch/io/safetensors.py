"""Zero-copy safetensors reader and a writer (a trimmed copy of the JAX
package's ``io/safetensors.py``).

A document maps its file through the native library
(`metalchat_tpu_torch.native.NativeMmap`: mmap, the header scan, then
WILLNEED over the whole file, so the kernel pages a checkpoint in ahead of
the reads that stack it for the upload). Tensors come back as numpy views
of the mapping; ``torch_tensor`` gives a CPU
torch tensor with the checkpoint's dtype (bf16 is read as raw 16-bit words
and reinterpreted, so numpy needs no bf16 type). `save_safetensors` writes
torch tensors (bf16 as its raw 16-bit words), `save_sharded_safetensors`
a sharded checkpoint with its index. ``rename`` and
``alias_if_missing`` rename tensors by regex and expose a tied weight under
a second name (the Meta-format loader's surgery).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.native import NativeMmap

# safetensors dtype tag → numpy storage dtype (BF16 as raw int16 words).
_DTYPES: Dict[str, np.dtype] = {
    "BOOL": np.dtype(np.bool_),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "I16": np.dtype(np.int16),
    "F16": np.dtype(np.float16),
    "BF16": np.dtype(np.int16),
    "I32": np.dtype(np.int32),
    "F32": np.dtype(np.float32),
    "F64": np.dtype(np.float64),
    "I64": np.dtype(np.int64),
}

_TORCH_TAGS = {torch.bool: "BOOL", torch.int8: "I8", torch.uint8: "U8", torch.int16: "I16",
               torch.float16: "F16", torch.bfloat16: "BF16", torch.int32: "I32",
               torch.float32: "F32", torch.float64: "F64", torch.int64: "I64"}

_MAX_HEADER_BYTES = 100 * 1024 * 1024


@dataclass(frozen=True)
class TensorEntry:
    name: str
    dtype: str            # safetensors tag, e.g. "BF16"
    shape: Tuple[int, ...]
    data_offsets: Tuple[int, int]

    @property
    def nbytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]

    @property
    def np_dtype(self) -> np.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported safetensors dtype {self.dtype!r}") from None


def parse_header(blob) -> Tuple[Dict[str, Any], list]:
    """8-byte LE length + JSON header → (metadata, entries by file offset)."""
    if len(blob) < 8:
        raise ValueError("safetensors: file shorter than header length field")
    header_len = int.from_bytes(bytes(blob[:8]), "little")
    if header_len > _MAX_HEADER_BYTES or 8 + header_len > len(blob):
        raise ValueError(f"safetensors: implausible header length {header_len}")
    header = json.loads(bytes(blob[8:8 + header_len]).decode("utf-8"))
    metadata = header.pop("__metadata__", {})
    entries = [
        TensorEntry(name=name, dtype=info["dtype"],
                    shape=tuple(int(s) for s in info["shape"]),
                    data_offsets=(int(info["data_offsets"][0]),
                                  int(info["data_offsets"][1])))
        for name, info in header.items()
    ]
    entries.sort(key=lambda e: e.data_offsets[0])
    for e in entries:
        expect = int(np.prod(e.shape, dtype=np.int64)) * e.np_dtype.itemsize
        if expect != e.nbytes:
            raise ValueError(f"safetensors: tensor {e.name!r} byte span {e.nbytes} "
                             f"!= shape/dtype implies {expect}")
    return metadata, entries


class SafetensorsDocument:
    """A read-only view over one safetensors file."""

    def __init__(self, entries: Sequence[TensorEntry], data: memoryview,
                 metadata: Optional[Mapping[str, Any]] = None, *, _owner: Any = None):
        self._entries: Dict[str, TensorEntry] = {e.name: e for e in entries}
        self._data = data
        self.metadata: Dict[str, Any] = dict(metadata or {})
        self._aliases: Dict[str, str] = {}
        self._owner = _owner  # the mapping behind ``data``

    @classmethod
    def open(cls, path: str | Path) -> "SafetensorsDocument":
        """Map the file (`NativeMmap`), parse its header, advise WILLNEED.
        The mapping is never unmapped on garbage collection, so the numpy
        views `tensor` hands out stay valid after the document is gone."""
        mapped = NativeMmap(path)
        try:
            view = mapped.view()
            metadata, entries = parse_header(view)
            mapped.advise("willneed")
        except BaseException:
            mapped.close()
            raise
        return cls(entries, view[8 + mapped.header_len:], metadata, _owner=mapped)

    def keys(self) -> Iterator[str]:
        yield from self._entries
        yield from self._aliases

    def __contains__(self, name: str) -> bool:
        return name in self._entries or name in self._aliases

    def entry(self, name: str) -> TensorEntry:
        return self._entries[self._aliases.get(name, name)]

    def tensor(self, name: str) -> np.ndarray:
        """Zero-copy numpy view (BF16 as int16 words); an alias reads its
        source."""
        e = self.entry(name)
        begin, end = e.data_offsets
        return np.frombuffer(self._data[begin:end], dtype=e.np_dtype).reshape(e.shape)

    __getitem__ = tensor

    def torch_tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor (a copy) with the checkpoint's dtype."""
        t = torch.from_numpy(self.tensor(name).copy())
        return t.view(torch.bfloat16) if self.entry(name).dtype == "BF16" else t

    def rename(self, pattern: str, replacement: str) -> "SafetensorsDocument":
        """Regex-rename every tensor (``re.sub``: ``\\1`` backreferences in
        ``replacement``); two names landing on one raise."""
        rx = re.compile(pattern)
        renamed: Dict[str, TensorEntry] = {}
        for name, e in self._entries.items():
            new = rx.sub(replacement, name)
            if new in renamed:
                raise ValueError(f"rename collision: {new!r}")
            renamed[new] = TensorEntry(new, e.dtype, e.shape, e.data_offsets)
        self._entries = renamed
        return self

    def alias(self, name: str, source: str) -> "SafetensorsDocument":
        """Expose tensor ``source`` under a second name (tied weights)."""
        if source not in self._entries:
            raise KeyError(source)
        self._aliases[name] = source
        return self

    def alias_if_missing(self, name: str, source: str) -> "SafetensorsDocument":
        if name not in self:
            self.alias(name, source)
        return self


class ShardedSafetensorsDocument(SafetensorsDocument):
    """Consolidated view over ``model.safetensors.index.json`` shards."""

    def __init__(self, index_path: str | Path):
        index_path = Path(index_path)
        index = json.loads(index_path.read_text())
        self._shards: Dict[str, SafetensorsDocument] = {}
        self._where: Dict[str, str] = {}
        for name, shard in index["weight_map"].items():
            if shard not in self._shards:
                self._shards[shard] = SafetensorsDocument.open(index_path.parent / shard)
            self._where[name] = shard
        entries = [self._shards[s].entry(n) for n, s in self._where.items()]
        super().__init__(entries, memoryview(b""), index.get("metadata", {}))

    def tensor(self, name: str) -> np.ndarray:
        name = self._aliases.get(name, name)
        return self._shards[self._where[name]].tensor(name)

    __getitem__ = tensor

    def rename(self, pattern: str, replacement: str) -> "ShardedSafetensorsDocument":
        rx = re.compile(pattern)
        self._where = {rx.sub(replacement, n): s for n, s in self._where.items()}
        for shard in self._shards.values():
            shard.rename(pattern, replacement)
        return super().rename(pattern, replacement)  # type: ignore[return-value]


def open_safetensors(path: str | Path) -> SafetensorsDocument:
    """Open a single file, a sharded index, or a directory holding either."""
    path = Path(path)
    if path.is_dir():
        index = path / "model.safetensors.index.json"
        if index.exists():
            return ShardedSafetensorsDocument(index)
        single = path / "model.safetensors"
        if single.exists():
            return SafetensorsDocument.open(single)
        raise FileNotFoundError(f"no safetensors checkpoint under {path}")
    if path.name.endswith(".index.json"):
        return ShardedSafetensorsDocument(path)
    return SafetensorsDocument.open(path)


def _raw(name: str, t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(safetensors tag, the tensor's bytes as a contiguous numpy array)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype not in _TORCH_TAGS:
        raise ValueError(f"cannot serialize dtype {t.dtype} for {name!r}")
    if t.dtype == torch.bfloat16:
        return "BF16", t.view(torch.int16).numpy()
    return _TORCH_TAGS[t.dtype], t.numpy()


def save_safetensors(path: str | Path, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Serialize torch tensors to a safetensors file, in the order given,
    the header padded to 8 bytes."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    arrays = []
    for name, t in tensors.items():
        tag, arr = _raw(name, t)
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with Path(path).open("wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())


def save_sharded_safetensors(directory: str | Path, tensors: Mapping[str, torch.Tensor], *,
                             max_shard_bytes: int = 5 * 1024**3,
                             metadata: Optional[Mapping[str, str]] = None) -> Path:
    """Write a sharded checkpoint and ``model.safetensors.index.json``, as the
    JAX package's writer does: tensors in the order given, a new shard once
    the next tensor would take a non-empty shard past ``max_shard_bytes``,
    shards named ``model-<i>-of-<n>.safetensors``. Returns the index path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    shards: list = [{}]
    sizes = [0]
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] and sizes[-1] + nbytes > max_shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    n = len(shards)
    weight_map: Dict[str, str] = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_safetensors(directory / fname, shard, metadata)
        for name in shard:
            weight_map[name] = fname
    index = {"metadata": {"total_size": int(sum(sizes))}, "weight_map": weight_map}
    index_path = directory / "model.safetensors.index.json"
    index_path.write_text(json.dumps(index, indent=2))
    return index_path
