"""Model repositories: local checkout directories and HuggingFace-style
remotes (port of the JAX package's ``io/repository.py``).

`FilesystemRepository` resolves the config, tokenizer and weights of a
local directory; `HuggingFaceRepository` clones a model's inference
artifacts over a read-only filesystem (a local directory, or HTTP with
bearer auth), so the transport is pluggable. A Meta-format checkout
(``params.json``) yields its config; its weights load under Meta names
with ``io.loaders.load_params(..., source="meta")``.
"""
from __future__ import annotations

import json
import shutil
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Protocol

from metalchat_tpu_torch.config import ModelConfig, load_config
from metalchat_tpu_torch.io.safetensors import SafetensorsDocument, open_safetensors
from metalchat_tpu_torch.text.loaders import AnyTokenizer, load_tokenizer

CONFIG_FILES = ("config.json", "params.json")
TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model")
WEIGHT_INDEX = "model.safetensors.index.json"
WEIGHT_FILE = "model.safetensors"


class ReadonlyFilesystem(Protocol):
    """Transport abstraction: a read-only filesystem."""

    def exists(self, name: str) -> bool: ...

    def read(self, name: str) -> bytes: ...

    def copy(self, name: str, dest: Path, progress: Optional[Callable[[int, int], None]] = None) -> None: ...


@dataclass
class LocalFilesystem:
    root: Path

    def exists(self, name: str) -> bool:
        return (self.root / name).exists()

    def read(self, name: str) -> bytes:
        return (self.root / name).read_bytes()

    def copy(self, name: str, dest: Path, progress=None) -> None:
        src = self.root / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        try:  # hard-link when possible
            if dest.exists():
                dest.unlink()
            import os

            os.link(src, dest)
        except OSError:
            shutil.copyfile(src, dest)
        if progress:
            size = src.stat().st_size
            progress(size, size)


@dataclass
class HttpFilesystem:
    """HuggingFace-hub transport: resolve/<revision>/<file> with bearer auth."""

    base_url: str                 # e.g. https://huggingface.co/meta-llama/Llama-3.2-1B
    token: Optional[str] = None
    revision: str = "main"
    chunk_size: int = 1 << 20

    def _url(self, name: str) -> str:
        base = self.base_url.rstrip("/")
        return f"{base}/resolve/{self.revision}/{urllib.parse.quote(name)}"

    def _request(self, name: str, method: str = "GET") -> urllib.request.Request:
        req = urllib.request.Request(self._url(name), method=method)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return req

    def exists(self, name: str) -> bool:
        try:
            with urllib.request.urlopen(self._request(name, "HEAD"), timeout=30):
                return True
        except Exception:
            return False

    def read(self, name: str) -> bytes:
        with urllib.request.urlopen(self._request(name), timeout=60) as resp:
            return resp.read()

    def copy(self, name: str, dest: Path, progress=None) -> None:
        dest.parent.mkdir(parents=True, exist_ok=True)
        with urllib.request.urlopen(self._request(name), timeout=60) as resp:
            total = int(resp.headers.get("Content-Length") or 0)
            done = 0
            with dest.open("wb") as f:
                while True:
                    chunk = resp.read(self.chunk_size)
                    if not chunk:
                        break
                    f.write(chunk)
                    done += len(chunk)
                    if progress:
                        progress(done, total)


@dataclass
class FilesystemRepository:
    """A fully materialized local model directory."""

    path: Path

    def retrieve_config(self) -> ModelConfig:
        """The checkout's ``config.json``, else its Meta ``params.json``."""
        for name in CONFIG_FILES:
            p = self.path / name
            if p.exists():
                return load_config(p)
        raise FileNotFoundError(f"no model config under {self.path}")

    def retrieve_tokenizer(self) -> AnyTokenizer:
        return load_tokenizer(self.path)

    def retrieve_weights(self) -> SafetensorsDocument:
        return open_safetensors(self.path)


@dataclass
class HuggingFaceRepository:
    """Clone a model repo's inference artifacts into a local directory."""

    fs: ReadonlyFilesystem

    def clone(
        self, dest: Path, progress: Optional[Callable[[str, int, int], None]] = None
    ) -> FilesystemRepository:
        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=True)

        def cp(name: str) -> None:
            cb = (lambda done, total: progress(name, done, total)) if progress else None
            self.fs.copy(name, dest / name, cb)

        copied_config = False
        for name in CONFIG_FILES:
            if self.fs.exists(name):
                cp(name)
                copied_config = True
                break
        if not copied_config:
            raise FileNotFoundError("remote has no config.json/params.json")
        for name in TOKENIZER_FILES:
            if self.fs.exists(name):
                cp(name)
                break
        else:
            raise FileNotFoundError("remote has no tokenizer artifact")

        if self.fs.exists(WEIGHT_INDEX):
            cp(WEIGHT_INDEX)
            index = json.loads((dest / WEIGHT_INDEX).read_text())
            for shard in sorted(set(index["weight_map"].values())):
                cp(shard)
        elif self.fs.exists(WEIGHT_FILE):
            cp(WEIGHT_FILE)
        else:
            raise FileNotFoundError("remote has no model.safetensors (or index)")
        return FilesystemRepository(dest)
