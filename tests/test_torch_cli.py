"""The port's CLI, store and repository (metalchat_tpu_torch/cli/,
io/repository.py) through the cases of ``tests/test_cli.py``, against the
JAX package's CLI, on the CPU (``--device cpu``: f32, the plain versions of
the kernels).

A fake HF checkout with tiny random weights → ``model pull`` → ``prompt``
/ ``-`` / ``checkout`` / ``serve``, with a greedy manifest: stdout equal to
the JAX CLI's (``serve``: every JSONL field but ``ttft_s``). The trained
fixture's ``serve`` gives ``tests/test_fixture_e2e.py``'s GOLDEN. The store,
manifests, TOML and credentials; a model pulled by one package's CLI is
listed and served by the other's; ``prompt --draft`` gives the JAX CLI's
reply; ``--pp`` and ``--cp`` in one process alone are refused (their ranks
run in tests/test_torch_pp_cp.py); a Meta
``params.json`` without its head count raises as the JAX package's does;
``--device`` defaults to the card and raises without one.
"""

import base64
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metalchat_tpu.cli import store as jstore
from metalchat_tpu.cli.main import main as jmain
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import merge_options as jmerge_options
from metalchat_tpu.io.loaders import save_params as jsave_params
from metalchat_tpu.io.safetensors import save_safetensors as jsave_safetensors
from metalchat_tpu.models import init_random_params as jinit_random_params
from metalchat_tpu_torch.cli import store
from metalchat_tpu_torch.cli.main import main
from metalchat_tpu_torch.cli.store import (
    CredentialStore,
    Manifest,
    ModelStore,
    dump_toml,
    load_scoped_manifest,
    model_id,
)
from metalchat_tpu_torch.config import LlamaConfig, load_config, merge_options
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.io.loaders import save_params
from metalchat_tpu_torch.io.repository import (
    FilesystemRepository,
    HuggingFaceRepository,
    LocalFilesystem,
)
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
PROMPT = b"def main():\n    "
GOLDEN = [32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 35, 32, 67, 114,
          101, 97, 116, 101, 32, 97, 32, 99, 108, 105, 101, 110, 116, 10, 32,
          32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 99, 108]
CPU = ["--device", "cpu"]
TINY_JSON = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
    "vocab_size": 300, "max_position_embeddings": 128,
    "tie_word_embeddings": False, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
}
JCFG = JLlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=8, max_seq_len=128,
                    tie_word_embeddings=False, rope_scaling=None)


@pytest.fixture()
def fake_checkout(tmp_path):
    """tests/test_cli.py's HF model directory: tiny random weights written by
    the JAX package, a 256-byte tokenizer.model."""
    src = tmp_path / "hub" / "tiny-llama"
    src.mkdir(parents=True)
    (src / "config.json").write_text(json.dumps(TINY_JSON))
    params = jinit_random_params(JCFG, seed=3, dtype=jnp.float32)
    tensors = {k: np.asarray(v, np.float32) for k, v in jsave_params(params, JCFG).items()}
    jsave_safetensors(src / "model.safetensors", tensors)
    lines = [f"{base64.b64encode(bytes([b])).decode()} {b}" for b in range(256)]
    (src / "tokenizer.model").write_text("\n".join(lines))
    return src


@pytest.fixture()
def store_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("METALCHAT_TPU_HOME", str(home))
    monkeypatch.chdir(tmp_path)
    return home


def _greedy(ref):
    """Give a stored model a greedy manifest ([inference.sampling])."""
    model = ModelStore().find(ref)
    manifest = Manifest.load(model.path / Manifest.FILENAME)
    manifest.inference["sampling"] = {"temperature": 0}
    manifest.save(model.path / Manifest.FILENAME)


def _stdout(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.fixture()
def pulled(fake_checkout, store_home):
    assert main(["model", "pull", str(fake_checkout), "--name", "tiny"]) == 0
    _greedy("tiny")
    return fake_checkout


# -- io ---------------------------------------------------------------------------

def test_save_params_and_safetensors_match_jax(tmp_path):
    """The port's HF-name writer gives the JAX package's file byte for byte,
    and reads back as it was."""
    jparams = jinit_random_params(JCFG, seed=3, dtype=jnp.float32)
    jsave_safetensors(tmp_path / "jax.safetensors",
                      {k: np.asarray(v) for k, v in jsave_params(jparams, JCFG).items()})
    params = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    cfg = load_config_from(TINY_JSON, tmp_path)
    tensors = save_params(params, cfg)
    save_safetensors(tmp_path / "port.safetensors", tensors)
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "jax.safetensors").read_bytes()
    bf16 = {k: v.to(torch.bfloat16) for k, v in tensors.items()}
    save_safetensors(tmp_path / "bf16.safetensors", bf16, metadata={"format": "pt"})
    doc = open_safetensors(tmp_path / "bf16.safetensors")
    assert doc.metadata == {"format": "pt"} and doc.entry("model.norm.weight").dtype == "BF16"
    for k, v in bf16.items():
        assert torch.equal(doc.torch_tensor(k), v)


def load_config_from(spec, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(spec))
    return load_config(tmp_path / "config.json")


@pytest.mark.parametrize("overrides", [
    {"rope_theta": 10000.0}, {"model.max_seq_len": 64, "rms_norm_eps": 1e-6},
    {"rope_scaling": {"factor": 4.0}}, {"eos_token_ids": 7}, {"nope": 1},
])
def test_merge_options_matches_jax(overrides):
    cfg = LlamaConfig.llama32_1b()
    try:
        want = jmerge_options(JLlamaConfig.llama32_1b(), overrides)
    except KeyError:
        with pytest.raises(KeyError, match="unknown option path"):
            merge_options(cfg, overrides)
        return
    got = merge_options(cfg, overrides)
    for name in overrides:
        field = name.split(".")[-1]
        mine, theirs = getattr(got, field), getattr(want, field)
        assert (mine.__dict__ if hasattr(mine, "__dict__") else mine) == \
            (theirs.__dict__ if hasattr(theirs, "__dict__") else theirs)


def test_clone_and_filesystem_repository(fake_checkout, tmp_path):
    repo = HuggingFaceRepository(LocalFilesystem(fake_checkout))
    events = []
    cloned = repo.clone(tmp_path / "cloned", progress=lambda n, d, t: events.append(n))
    assert {"config.json", "model.safetensors", "tokenizer.model"} <= set(events)
    assert cloned.retrieve_config().hidden_size == 32
    assert cloned.retrieve_tokenizer().encode("hi") == [104, 105]
    assert "model.embed_tokens.weight" in cloned.retrieve_weights()


def test_clone_missing_artifacts(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="config"):
        HuggingFaceRepository(LocalFilesystem(empty)).clone(tmp_path / "out")


def test_meta_params_json_raises(tmp_path):
    """A Meta ``params.json`` is read (tests/test_torch_meta.py holds its
    mapping); one without ``n_heads`` raises KeyError in both packages."""
    from metalchat_tpu.io.repository import FilesystemRepository as JFilesystemRepository

    (tmp_path / "params.json").write_text(json.dumps({"dim": 64, "n_layers": 2}))
    for repo in (FilesystemRepository(tmp_path), JFilesystemRepository(tmp_path)):
        with pytest.raises(KeyError, match="n_heads"):
            repo.retrieve_config()


# -- store, manifests, credentials ---------------------------------------------------

def test_model_store_pull_list_remove(fake_checkout, store_home):
    s = ModelStore()
    model = s.pull(str(fake_checkout), name="tiny")
    assert model.id == model_id(str(fake_checkout)) == jstore.model_id(str(fake_checkout))
    assert s.find("tiny") is not None and s.find(model.id[:8]) is not None
    listed = s.list()
    assert len(listed) == 1 and listed[0].name == "tiny"
    assert s.remove("tiny")
    assert s.list() == [] and not s.remove("tiny")


def test_manifest_scopes(store_home):
    store_home.mkdir(parents=True, exist_ok=True)
    Manifest(options={"rope_theta": 1}, inference={"max_sequence_length": 64}).save(
        store_home / Manifest.FILENAME)
    Manifest(options={"rope_theta": 2}).save(Path.cwd() / Manifest.FILENAME)
    merged = load_scoped_manifest()
    assert merged.options["rope_theta"] == 2
    assert merged.merged_overrides()["max_seq_len"] == 64
    assert merged == Manifest(**jstore.load_scoped_manifest().__dict__)


def test_toml_roundtrip():
    import tomllib

    data = {"model": {"url": "https://x", "name": "n a=b"},
            "inference": {"max_sequence_length": 128, "flag": True,
                          "sampling": {"temperature": 0.5, "k": 10}}}
    assert tomllib.loads(dump_toml(data)) == data
    assert dump_toml(data) == jstore.dump_toml(data)


def test_credentials(store_home):
    creds = CredentialStore(use_keyring=False)
    creds.add("huggingface.co", "hf_secret")
    assert creds.get("huggingface.co") == "hf_secret"
    assert creds.list_hosts() == ["huggingface.co"]
    assert oct(creds.path.stat().st_mode & 0o777) == "0o600"
    assert jstore.CredentialStore(use_keyring=False).get("huggingface.co") == "hf_secret"
    creds.remove("huggingface.co")
    assert creds.get("huggingface.co") is None


def test_credentials_keyring(store_home, monkeypatch):
    class FakeKeyring:
        def __init__(self):
            self.db = {}

        def set_password(self, service, host, token):
            self.db[(service, host)] = token

        def get_password(self, service, host):
            return self.db.get((service, host))

        def delete_password(self, service, host):
            del self.db[(service, host)]

    fake = FakeKeyring()
    monkeypatch.setattr("metalchat_tpu_torch.cli.store._keyring", lambda: fake)
    creds = CredentialStore()
    creds.add("huggingface.co", "hf_secret")
    assert creds.get("huggingface.co") == "hf_secret"
    assert "hf_secret" not in creds.path.read_text() and "@keyring" in creds.path.read_text()
    assert creds.list_hosts() == ["huggingface.co"]
    creds.remove("huggingface.co")
    assert creds.get("huggingface.co") is None and fake.db == {}


def test_secret_tool_backend(tmp_path, monkeypatch):
    db = tmp_path / "secrets.json"
    tool = tmp_path / "secret-tool"
    tool.write_text(f"""#!/usr/bin/env python3
import json, sys, pathlib
db = pathlib.Path({str(db)!r})
data = json.loads(db.read_text()) if db.exists() else {{}}
cmd = sys.argv[1]
key = "|".join(sys.argv[-4:])
if cmd == "store":
    data[key] = sys.stdin.read()
elif cmd == "lookup":
    v = data.get(key)
    if v is None: sys.exit(1)
    sys.stdout.write(v)
elif cmd == "clear":
    data.pop(key, None)
db.write_text(json.dumps(data))
""")
    tool.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    creds = CredentialStore(path=tmp_path / "config.toml")
    assert isinstance(creds._kr, store._SecretTool)
    creds.add("huggingface.co", "hf_secret_token")
    assert "hf_secret_token" not in (tmp_path / "config.toml").read_text()
    assert creds.get("huggingface.co") == "hf_secret_token"
    creds.remove("huggingface.co")
    assert creds.get("huggingface.co") is None


# -- the CLI -------------------------------------------------------------------------

def test_cli_model_and_credential_commands(fake_checkout, store_home, capsys):
    assert main(["model", "pull", str(fake_checkout), "--name", "tiny"]) == 0
    assert main(["model", "list"]) == 0
    assert "tiny" in capsys.readouterr().out
    assert main(["credential", "add", "huggingface.co", "tok"]) == 0
    assert main(["credential", "list"]) == 0
    assert "huggingface.co" in capsys.readouterr().out
    assert main(["credential", "remove", "huggingface.co"]) == 0
    assert main(["model", "remove", "tiny"]) == 0
    assert main(["model", "remove", "tiny"]) == 1
    assert main([]) == 2


def test_cli_options_commands(store_home, capsys):
    assert main(["options", "set", "rope_theta", "10000", "--scope", "global"]) == 0
    assert main(["options", "set", "inference.max_sequence_length", "64",
                 "--scope", "global"]) == 0
    assert main(["options", "get", "rope_theta", "--scope", "global"]) == 0
    assert capsys.readouterr().out.strip() == "10000"
    assert main(["options", "list", "--scope", "global"]) == 0
    listed = capsys.readouterr().out
    assert jmain(["options", "list", "--scope", "global"]) == 0
    assert capsys.readouterr().out == listed and "inference.max_sequence_length" in listed
    assert main(["options", "unset", "rope_theta", "--scope", "global"]) == 0
    assert main(["options", "get", "rope_theta", "--scope", "global"]) == 1


@pytest.mark.parametrize("flags", [[], ["--quantize", "int8"], ["--quantize", "w4a8"],
                                   ["--system", "Be brief.", "--quantize", "int4"]],
                         ids=["f32", "int8", "w4a8", "system-int4"])
def test_cli_prompt_matches_jax(pulled, flags):
    """model pull → prompt -c: the streamed reply equal to the JAX CLI's."""
    argv = ["prompt", "tiny", "-c", "hello world", "--max-tokens", "10"] + flags
    got = _stdout(main, argv + CPU)
    assert got == _stdout(jmain, argv) and got.endswith("\n") and len(got) > 1


def test_cli_prompt_from_stdin(pulled, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("hello from stdin"))
    got = _stdout(main, ["-", "tiny", "--max-tokens", "6"] + CPU)
    monkeypatch.setattr("sys.stdin", io.StringIO("hello from stdin"))
    assert got == _stdout(jmain, ["-", "tiny", "--max-tokens", "6"])


def test_cli_checkout_matches_jax(pulled, monkeypatch):
    """Two lines, then an empty one: two replies, as the JAX CLI prints."""
    outs = []
    for fn, extra in ((main, CPU), (jmain, [])):
        lines = iter(["hello", "and again", ""])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
        outs.append(_stdout(fn, ["checkout", "tiny", "--max-tokens", "5"] + extra))
    assert outs[0] == outs[1] and outs[0].count("\n") == 3


def test_cli_unknown_model(store_home):
    with pytest.raises(SystemExit, match="not found"):
        main(["prompt", "missing", "-c", "x"] + CPU)


def test_cli_serve_jsonl_matches_jax(pulled, tmp_path):
    """serve: JSONL prompts → continuous batching → JSONL completions, every
    field equal to the JAX CLI's but the time to first token."""
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in [
        {"prompt": "hello", "max_tokens": 3}, {"prompt": "bye", "max_tokens": 2},
        {"prompt": "<|begin_of_text|>x", "max_tokens": 5}]) + "\n")
    argv = ["serve", "tiny", "--input", str(reqs), "--slots", "2", "--max-tokens", "3"]
    outs = []
    for fn, extra in ((main, CPU), (jmain, [])):
        lines = [json.loads(line) for line in _stdout(fn, argv + extra).splitlines()]
        for line in lines:
            assert line.pop("ttft_s") > 0
        outs.append(lines)
    assert outs[0] == outs[1]
    assert [line["tokens"] for line in outs[0]] == [3, 2, 5]


def test_cli_fixture_serve_golden(tmp_path, monkeypatch):
    """The trained fixture through model pull → serve, f32 on the CPU: the
    greedy continuation of tests/test_fixture_e2e.py's GOLDEN."""
    monkeypatch.setenv("METALCHAT_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    assert main(["model", "pull", str(FIXTURE), "--name", "pyllama"]) == 0
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"prompt": PROMPT.decode(), "max_tokens": 24,
                                "temperature": 0.0}) + "\n")
    out = _stdout(main, ["serve", "pyllama", "--input", str(reqs), "--slots", "2",
                         "--max-seq-len", "256"] + CPU)
    assert json.loads(out.splitlines()[0])["text"] == bytes(GOLDEN[:24]).decode()


@pytest.mark.parametrize("puller", ["jax", "port"])
def test_model_pulled_by_either_cli(fake_checkout, store_home, capsys, puller):
    """One home, one layout: a model either CLI pulled is listed, and
    prompted, by the other."""
    pull, other = (jmain, main) if puller == "jax" else (main, jmain)
    assert pull(["model", "pull", str(fake_checkout), "--name", "shared"]) == 0
    capsys.readouterr()
    assert other(["model", "list"]) == 0
    assert "shared" in capsys.readouterr().out
    _greedy("shared")
    argv = ["prompt", "shared", "-c", "hi", "--max-tokens", "4"]
    assert _stdout(main, argv + CPU) == _stdout(jmain, argv)


@pytest.mark.parametrize("argv,item", [
    (["serve", "tiny", "--pp", "2"], "start 2 processes"),
    (["serve", "tiny", "--cp", "2"], "start 2 processes"),
])
def test_unported_options_raise(pulled, argv, item, monkeypatch):
    """``serve --pp/--cp N`` runs as N processes, one a rank
    (tests/test_torch_pp_cp.py runs them): one process alone is refused,
    with how to start the ranks."""
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=item):
        main(argv + CPU)


@pytest.mark.parametrize("n_draft", [2, 3])
def test_cli_prompt_draft_matches_jax(pulled, n_draft):
    """prompt --draft (the tiny checkout as its own draft, no step-ratio
    check): stdout equal to the JAX CLI's and to the greedy ``prompt``."""
    argv = ["prompt", "tiny", "-c", "hello world", "--max-tokens", "10"]
    draft = ["--draft", "tiny", "--n-draft", str(n_draft), "--no-draft-check"]
    got = _stdout(main, argv + draft + CPU)
    assert got == _stdout(jmain, argv + draft) == _stdout(main, argv + CPU)


def test_device_defaults_to_the_card(pulled, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["prompt", "tiny", "-c", "x"])
    assert main.__module__ == "metalchat_tpu_torch.cli.main"
    from metalchat_tpu_torch.cli.main import build_parser

    assert build_parser().parse_args(["prompt", "tiny"]).device == "cuda"


def test_model_pull_http_with_auth(fake_checkout, tmp_path, store_home):
    """model pull over HTTP (a server on 127.0.0.1) with bearer auth from
    the credential store, then a prompt on the clone."""
    import http.server
    import threading

    token = "tok-12345"

    class Handler(http.server.BaseHTTPRequestHandler):
        def _serve(self, head=False):
            if self.headers.get("Authorization") != f"Bearer {token}":
                self.send_response(401)
                self.end_headers()
                return
            parts = self.path.split("/resolve/main/", 1)
            p = fake_checkout / (parts[1] if len(parts) == 2 else "missing")
            if not p.exists():
                self.send_response(404)
                self.end_headers()
                return
            data = p.read_bytes()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            if not head:
                self.wfile.write(data)

        def do_GET(self):
            self._serve()

        def do_HEAD(self):
            self._serve(head=True)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/fake/model"
        host = f"127.0.0.1:{srv.server_address[1]}"
        with pytest.raises(Exception):
            main(["model", "pull", url, "--name", "authless"])
        assert main(["credential", "add", host, token]) == 0
        assert main(["model", "pull", url, "--name", "authed"]) == 0
        assert main(["prompt", "authed", "-c", "hi", "--max-tokens", "2"] + CPU) == 0
    finally:
        srv.shutdown()
