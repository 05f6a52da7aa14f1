"""The host's native runtime, loaded with ctypes (the port's own copy of the
JAX package's ``native/``; it never loads that package's library).

* ``safetensors.cc``: mmap, header scan and page-cache advice, the data
  plane under `io.safetensors` (WILLNEED before the tensors are read and
  stacked for the upload to the card);
* ``bpe.cc``: the greedy lowest-rank merge loop under `text.bpe`'s
  tiktoken-rank byte mode.

The library builds with ``g++`` at first use (`build.build`). A failed
build or load raises with the compiler's or the loader's message: there is
no switch that turns the library off and no silent fallback to Python.
This module imports neither torch nor jax.

``CALLS`` counts the calls that went through the library (mappings opened,
pieces encoded), as ``ops.LAUNCHES`` counts kernel launches, so a run can
show that its path really took it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

CALLS: Dict[str, int] = {"mmap_open": 0, "encode_piece": 0}

_ADVICE = {"normal": 0, "willneed": 1, "sequential": 2, "dontneed": 3}
_LIB: Optional[ctypes.CDLL] = None


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is None:
        # Imported here so that `python -m metalchat_tpu_torch.native.build`
        # runs a module the package has not imported yet.
        from metalchat_tpu_torch.native import build

        lib = ctypes.CDLL(str(build.build()), use_errno=True)
        c = ctypes
        lib.mc_mmap_open.restype = c.c_void_p
        lib.mc_mmap_open.argtypes = [c.c_char_p]
        lib.mc_mmap_data.restype = c.c_void_p
        lib.mc_mmap_data.argtypes = [c.c_void_p]
        lib.mc_mmap_size.restype = c.c_uint64
        lib.mc_mmap_size.argtypes = [c.c_void_p]
        lib.mc_header_len.restype = c.c_uint64
        lib.mc_header_len.argtypes = [c.c_void_p]
        lib.mc_mmap_advise.restype = c.c_int
        lib.mc_mmap_advise.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64, c.c_int]
        lib.mc_mmap_close.restype = None
        lib.mc_mmap_close.argtypes = [c.c_void_p]
        lib.mc_bpe_create.restype = c.c_void_p
        lib.mc_bpe_create.argtypes = [c.POINTER(c.c_uint8), c.POINTER(c.c_uint64),
                                      c.POINTER(c.c_int64), c.c_uint64]
        lib.mc_bpe_destroy.restype = None
        lib.mc_bpe_destroy.argtypes = [c.c_void_p]
        lib.mc_bpe_encode.restype = c.c_int64
        lib.mc_bpe_encode.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_uint64,
                                      c.POINTER(c.c_int64)]
        _LIB = lib
    return _LIB


class NativeMmap:
    """A read-only mapping of one file (the reference's basic_memfile).

    Views are zero-copy. There is deliberately no unmapping on garbage
    collection: numpy views handed out by a document may outlive it, and
    unmapping under them reads freed pages (the JAX package saw garbage
    logits from a temporary document). A mapping lives until `close` or the
    end of the process."""

    def __init__(self, path):
        self._lib = library()
        self._handle = None
        ctypes.set_errno(0)
        handle = self._lib.mc_mmap_open(os.fsencode(path))
        if not handle:
            err = ctypes.get_errno()
            raise OSError(err, os.strerror(err) if err else "cannot map the file", str(path))
        self._handle = handle
        CALLS["mmap_open"] += 1

    def _open_handle(self):
        if not self._handle:
            raise ValueError("the mapping is closed")
        return self._handle

    @property
    def size(self) -> int:
        return self._lib.mc_mmap_size(self._open_handle())

    @property
    def header_len(self) -> int:
        """The safetensors header's length, read by the library; 0 when it
        is implausible."""
        return self._lib.mc_header_len(self._open_handle())

    def view(self) -> memoryview:
        """A zero-copy, read-only byte view of the whole mapping (its pages
        are mapped read-only: a write would fault)."""
        address = self._lib.mc_mmap_data(self._open_handle())
        array = (ctypes.c_uint8 * self.size).from_address(address)
        return memoryview(array).cast("B").toreadonly()

    def advise(self, advice: str, offset: int = 0, length: Optional[int] = None) -> None:
        """madvise ``advice`` ("normal", "willneed", "sequential" or
        "dontneed") over ``[offset, offset + length)``, the rest of the file
        by default."""
        if advice not in _ADVICE:
            raise ValueError(f"unknown advice {advice!r}: one of {sorted(_ADVICE)}")
        size = self.size
        length = size - offset if length is None else length
        if offset < 0 or length < 0 or offset + length > size:
            raise ValueError(f"advice range [{offset}, {offset + length}) outside the "
                             f"{size}-byte mapping")
        ctypes.set_errno(0)
        if self._lib.mc_mmap_advise(self._handle, offset, length, _ADVICE[advice]) != 0:
            err = ctypes.get_errno()
            raise OSError(err, f"madvise({advice}): {os.strerror(err)}")

    def close(self) -> None:
        """Unmap. Every view of the mapping is invalid afterwards."""
        if self._handle:
            self._lib.mc_mmap_close(self._handle)
            self._handle = None


class NativeBPE:
    """The native merge loop over a tiktoken rank table (token bytes → id)."""

    def __init__(self, vocab: Dict[bytes, int]):
        self._lib = library()
        self._handle = None
        tokens = list(vocab)
        blob = b"".join(tokens)
        offsets = [0]
        for tok in tokens:
            offsets.append(offsets[-1] + len(tok))
        n = len(tokens)
        blob_arr = (ctypes.c_uint8 * max(1, len(blob))).from_buffer_copy(blob.ljust(1, b"\0"))
        off_arr = (ctypes.c_uint64 * (n + 1))(*offsets)
        id_arr = (ctypes.c_int64 * max(1, n))(*vocab.values())
        self._handle = self._lib.mc_bpe_create(blob_arr, off_arr, id_arr, n)

    def encode_piece(self, piece: bytes) -> Optional[List[int]]:
        """The ids of one pre-split piece, or None when a symbol left after
        merging is not in the vocabulary (the caller's byte-fallback
        handling decides)."""
        n = len(piece)
        if n == 0:
            return []
        buf = (ctypes.c_uint8 * n).from_buffer_copy(piece)
        out = (ctypes.c_int64 * n)()
        CALLS["encode_piece"] += 1
        written = self._lib.mc_bpe_encode(self._handle, buf, n, out)
        return None if written < 0 else out[:written]

    def __del__(self):
        if self._handle:
            self._lib.mc_bpe_destroy(self._handle)
            self._handle = None
