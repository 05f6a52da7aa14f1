"""Build the port's native library: ``python -m metalchat_tpu_torch.native.build``.

``safetensors.cc`` and ``bpe.cc`` compile with ``g++ -O2 -std=c++20 -shared
-fPIC`` into one shared library with a plain C interface, at first use, into
``metalchat_tpu_torch/build/`` (listed in ``.gitignore``). The file is named
``libmetalchat_native-<hash>.so`` by a hash of the sources, the compiler and
its flags, so an unchanged tree never recompiles and an edited source never
loads an older build. The compiler writes a temporary file of its own
process's, which ``os.replace`` then renames: processes that build at once
(test workers) never load a half-written library.

A failed build raises with the compiler's output and leaves no library
behind.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build"
SOURCES = ("safetensors.cc", "bpe.cc")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++20", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library of these sources, compiler and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libmetalchat_native-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError when the compiler cannot be run or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd), flush=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build the native library with {CXX}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed (rc={proc.returncode}) building the native "
                           f"library:\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
