"""Model store, manifests and credentials (port of the JAX package's
``cli/store.py``, with the same home and layout, so a model either
package's CLI pulled is found by the other's).

  * `ModelStore`: models live under ``$METALCHAT_TPU_HOME/models/<sha1>``,
    the id the SHA-1 of the normalized repo URL + variant; a pull
    dispatches on the URL's scheme (``file://`` or a path hard-links,
    https streams).
  * `Manifest`: ``metalchat.toml`` with model / options / inference
    sections, in three scopes layered model ← global (home) ← local (cwd).
  * `CredentialStore`: bearer tokens by host, in the OS keyring when one is
    available (the ``keyring`` package or the ``secret-tool`` CLI), else in
    ``config.toml`` with mode 0600.
"""
from __future__ import annotations

import hashlib
import json
import os
import tomllib
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from metalchat_tpu_torch.io.repository import (
    FilesystemRepository,
    HttpFilesystem,
    HuggingFaceRepository,
    LocalFilesystem,
)


def home_dir() -> Path:
    return Path(os.environ.get("METALCHAT_TPU_HOME", Path.home() / ".metalchat_tpu"))


# ---------------------------------------------------------------- manifests


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    return json.dumps(str(v))


import re as _re

_BARE_KEY = _re.compile(r"^[A-Za-z0-9_-]+$")


def _toml_key(k: str) -> str:
    return k if _BARE_KEY.match(k) else json.dumps(k)


def dump_toml(data: Dict[str, Any]) -> str:
    """Minimal TOML writer for manifest/config tables (scalars + one level
    of nested tables)."""
    lines: List[str] = []
    scalars = {k: v for k, v in data.items() if not isinstance(v, dict)}
    tables = {k: v for k, v in data.items() if isinstance(v, dict)}
    for k, v in scalars.items():
        lines.append(f"{_toml_key(k)} = {_toml_value(v)}")
    for name, table in tables.items():
        lines.append(f"\n[{_toml_key(name)}]")
        for k, v in table.items():
            if isinstance(v, dict):
                lines.append(f"\n[{_toml_key(name)}.{_toml_key(k)}]")
                for kk, vv in v.items():
                    lines.append(f"{_toml_key(kk)} = {_toml_value(vv)}")
            else:
                lines.append(f"{_toml_key(k)} = {_toml_value(v)}")
    return "\n".join(lines) + "\n"


@dataclass
class Manifest:
    """metalchat.toml equivalent."""

    model: Dict[str, Any] = field(default_factory=dict)        # url, name, variant
    options: Dict[str, Any] = field(default_factory=dict)      # model option overrides
    inference: Dict[str, Any] = field(default_factory=dict)    # max_sequence_length, sampling

    FILENAME = "metalchat.toml"

    @classmethod
    def load(cls, path: Path) -> "Manifest":
        data = tomllib.loads(path.read_text())
        return cls(
            model=data.get("model", {}),
            options=data.get("options", {}),
            inference=data.get("inference", {}),
        )

    def save(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(dump_toml(
            {"model": self.model, "options": self.options, "inference": self.inference}
        ))

    def merged_overrides(self) -> Dict[str, Any]:
        """Flatten options + inference into dotted-path config overrides."""
        out = dict(self.options)
        if "max_sequence_length" in self.inference:
            out["max_seq_len"] = int(self.inference["max_sequence_length"])
        return out

    def merge(self, other: "Manifest") -> "Manifest":
        """Other's entries win (scope layering local > global > model)."""
        return Manifest(
            model={**self.model, **other.model},
            options={**self.options, **other.options},
            inference={**self.inference, **other.inference},
        )


def load_scoped_manifest(store_dir: Optional[Path] = None) -> Manifest:
    """Layer model-scope ← global-scope ← local-scope manifests."""
    manifest = Manifest()
    scopes = []
    if store_dir is not None:
        scopes.append(store_dir / Manifest.FILENAME)
    scopes.append(home_dir() / Manifest.FILENAME)
    scopes.append(Path.cwd() / Manifest.FILENAME)
    for path in scopes:
        if path.exists():
            manifest = manifest.merge(Manifest.load(path))
    return manifest


# -------------------------------------------------------------- credentials


class _SecretTool:
    """libsecret CLI backend (`secret-tool`, the freedesktop Secret
    Service). Used when the `keyring` package is absent but a desktop
    keyring daemon is running; same three-call surface as the keyring
    module."""

    def __init__(self, exe: str):
        self.exe = exe

    def set_password(self, service: str, host: str, token: str) -> None:
        import subprocess

        subprocess.run(
            [self.exe, "store", "--label", f"{service}/{host}",
             "service", service, "host", host],
            input=token.encode(), check=True, capture_output=True)

    def get_password(self, service: str, host: str) -> Optional[str]:
        import subprocess

        out = subprocess.run(
            [self.exe, "lookup", "service", service, "host", host],
            capture_output=True)
        if out.returncode != 0:
            return None
        return out.stdout.decode().strip() or None

    def delete_password(self, service: str, host: str) -> None:
        import subprocess

        subprocess.run([self.exe, "clear", "service", service, "host", host],
                       capture_output=True, check=True)


def _keyring():
    """Optional OS secret store. Probe order: the `keyring` package with a
    real backend, then the `secret-tool` CLI (libsecret / Secret Service);
    otherwise the 0600 TOML file below is the store. Never required."""
    try:
        import keyring
        from keyring.backends.fail import Keyring as _Fail

        if not isinstance(keyring.get_keyring(), _Fail):
            return keyring
    except Exception:
        pass
    import shutil

    exe = shutil.which("secret-tool")
    if exe:
        return _SecretTool(exe)
    return None


class CredentialStore:
    """Bearer tokens by host: the OS keyring when one is available, else a
    0600 file."""

    SERVICE = "metalchat-tpu"

    def __init__(self, path: Optional[Path] = None, use_keyring: bool = True):
        self.path = path or (home_dir() / "config.toml")
        self._kr = _keyring() if use_keyring else None

    def _load(self) -> Dict[str, Any]:
        if not self.path.exists():
            return {}
        return tomllib.loads(self.path.read_text())

    def _save(self, data: Dict[str, Any]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(dump_toml(data))
        self.path.chmod(0o600)

    def add(self, host: str, token: str) -> None:
        if self._kr is not None:
            self._kr.set_password(self.SERVICE, host, token)
            # The host list stays in the file (keyrings can't enumerate);
            # the secret itself never touches disk.
            data = self._load()
            data.setdefault("credentials", {})[host] = "@keyring"
            self._save(data)
            return
        data = self._load()
        data.setdefault("credentials", {})[host] = token
        self._save(data)

    def get(self, host: str) -> Optional[str]:
        stored = self._load().get("credentials", {}).get(host)
        if stored == "@keyring" and self._kr is not None:
            return self._kr.get_password(self.SERVICE, host)
        return stored

    def remove(self, host: str) -> None:
        data = self._load()
        stored = data.get("credentials", {}).pop(host, None)
        self._save(data)
        if stored == "@keyring" and self._kr is not None:
            try:
                self._kr.delete_password(self.SERVICE, host)
            except Exception:
                pass

    def list_hosts(self) -> List[str]:
        return sorted(self._load().get("credentials", {}))


# -------------------------------------------------------------- model store


def model_id(url: str, variant: str = "") -> str:
    """SHA-1 id of the normalized repo URL + variant."""
    normalized = url.strip().rstrip("/").lower() + "\n" + variant
    return hashlib.sha1(normalized.encode()).hexdigest()


@dataclass
class StoredModel:
    id: str
    path: Path
    manifest: Manifest

    @property
    def name(self) -> str:
        return self.manifest.model.get("name") or self.manifest.model.get("url", self.id)


class ModelStore:
    def __init__(self, root: Optional[Path] = None):
        self.root = root or (home_dir() / "models")

    def _dir(self, mid: str) -> Path:
        return self.root / mid

    def list(self) -> List[StoredModel]:
        out = []
        if not self.root.exists():
            return out
        for d in sorted(self.root.iterdir()):
            mpath = d / Manifest.FILENAME
            if d.is_dir() and mpath.exists():
                out.append(StoredModel(d.name, d, Manifest.load(mpath)))
        return out

    def find(self, ref: str) -> Optional[StoredModel]:
        """Resolve by id prefix, name, or URL."""
        models = self.list()
        by_url_id = model_id(ref)
        for m in models:
            if m.id == ref or m.id == by_url_id or m.id.startswith(ref):
                return m
        for m in models:
            if m.name == ref or m.manifest.model.get("url") == ref:
                return m
        return None

    def remove(self, ref: str) -> bool:
        m = self.find(ref)
        if m is None:
            return False
        import shutil

        shutil.rmtree(m.path)
        return True

    def pull(
        self,
        url: str,
        *,
        name: Optional[str] = None,
        token: Optional[str] = None,
        progress=None,
    ) -> StoredModel:
        """Clone a model into the store."""
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme in ("", "file"):
            fs = LocalFilesystem(Path(parsed.path if parsed.scheme else url))
        elif parsed.scheme in ("http", "https"):
            if token is None:
                token = CredentialStore().get(parsed.netloc)
            fs = HttpFilesystem(url, token=token)
        else:
            raise ValueError(f"unsupported URL scheme {parsed.scheme!r}")
        mid = model_id(url)
        dest = self._dir(mid)
        HuggingFaceRepository(fs).clone(dest, progress=progress)
        manifest = Manifest(model={"url": url, "name": name or url.rstrip("/").split("/")[-1]})
        manifest.save(dest / Manifest.FILENAME)
        return StoredModel(mid, dest, manifest)

    def repository(self, ref: str) -> FilesystemRepository:
        m = self.find(ref)
        if m is None:
            raise FileNotFoundError(f"model {ref!r} not in store — `model pull` it first")
        return FilesystemRepository(m.path)
