"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. Builds run at first use,
into ``metalchat_tpu_torch/build/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so an unchanged tree never recompiles.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -std=c++17`` and never
``--use_fast_math``: the kernels rely on IEEE division, ``sqrtf`` and
round-half-even (``rintf``) to match the reference's integer codes.

Each wrapper counts its launches in ``LAUNCHES`` (one per kernel launch, and
nowhere else), so a run can show that its path really went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("a8_matvec", "decode_attention", "flash_attention", "paged_attention",
           "quant_matmul", "ffn_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "a8_matvec": 0, "a8_matvec_raw": 0, "a8_quantize": 0, "decode_attention_update": 0,
    "decode_attention": 0, "flash_attention": 0, "paged_decode_attention_update": 0,
    "paged_decode_attention": 0, "quant_matmul": 0, "ffn_block": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._out, proc._tmp, proc._log = out, tmp, log  # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    proc._log.close()  # type: ignore[attr-defined]
    log_path = proc._out.with_suffix(".log")  # type: ignore[attr-defined]
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n"
                           + log_path.read_text()[-4000:])
    os.replace(proc._tmp, proc._out)  # type: ignore[attr-defined]


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every kernel library not yet built, one ``nvcc`` per source,
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    procs = {n: _start_build(n) for n in names}
    for n, p in procs.items():
        if p is not None:
            _finish_build(n, p)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Arrival counters of the kernels' in-launch merges (decode and paged
# attention, the split-K dequant matmul), int32, by device. Zeroed once when
# made; every launch leaves the counters it used at zero, so launches on one
# stream can share them (they must not run concurrently on two streams). A
# grown buffer keeps the old one alive, since a captured CUDA graph may still
# launch on it.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_RETIRED: list = []


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's gate: the plain version serves CPU tensors only, so any
    other device must be CUDA (and all operands on the same card)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}; the plain "
                           "version runs only for CPU tensors")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: operands must be contiguous")
