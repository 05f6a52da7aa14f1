"""Structural rules of the PyTorch port.

* No file of `metalchat_tpu_torch/` (its `parallel/` included: the mesh,
  distributed, tensor-parallel, multi-host, pipeline, context-parallel and
  ring-attention modules too), nor `chip_smoke.py`, nor the parallel
  tests' rank workers (`tests/torch_tp_worker.py`,
  `tests/torch_pp_cp_worker.py`, `tests/torch_mesh_axes_worker.py`,
  `tests/torch_train_worker.py`, `tests/torch_train_moe_worker.py`)
  imports jax or the JAX package
  `metalchat_tpu`.
* An entry point asked for the card without one raises, and a kernel
  wrapper given a tensor that is not on the CPU or a card raises: neither
  falls back to the plain version.
* The text, chat and CLI layers load without the packages the card's
  machine lacks (``regex``, ``jsonschema``, ``jinja2``): importing them
  pulls in none of those, nor jax or the JAX package.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "metalchat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tp_worker.py",
    ROOT / "tests" / "torch_pp_cp_worker.py", ROOT / "tests" / "torch_mesh_axes_worker.py",
    ROOT / "tests" / "torch_train_worker.py", ROOT / "tests" / "torch_train_moe_worker.py"]
PARALLEL_MODULES = ("pipeline", "context", "ring_attention", "mesh", "distributed",
                    "tp_decode", "multihost")


def test_parallel_modules_are_checked():
    """The parallel modules (the mesh, distributed, tensor-parallel,
    multi-host, pipeline, context-parallel and ring-attention ones) exist
    and are among the files `test_port_imports_no_jax` reads."""
    for name in PARALLEL_MODULES:
        assert ROOT / "metalchat_tpu_torch" / "parallel" / f"{name}.py" in PORT_FILES


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "metalchat_tpu"), f"{path} imports {mod}"


def test_default_device_without_cuda_raises(monkeypatch):
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                      num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_random_quantized_params(cfg, group_size=None, act_bits=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuantizedKVCache.create(cfg, 1, 32, device="cuda")
    QuantizedKVCache.create(cfg, 1, 32, device="cpu")  # the CPU only on request


def test_wrappers_do_not_fall_back():
    from metalchat_tpu_torch.ops import (
        decode_attention_update_quantized_stacked,
        flash_attention,
        paged_decode_attention,
        paged_decode_attention_stacked,
        paged_decode_attention_update_stacked,
        quant_matvec_stacked,
        quant_matvec_stacked_fused,
    )

    meta = dict(device="meta")
    x = torch.empty(1, 64, dtype=torch.bfloat16, **meta)
    p = torch.empty(1, 32, 32, dtype=torch.int8, **meta)
    s = torch.empty(1, 1, 32, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        quant_matvec_stacked_fused(x, p, s, 0, bits=4)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        quant_matvec_stacked(torch.empty(1, 64, dtype=torch.int8, **meta), p, 0, bits=4)
    q = torch.empty(1, 2, 1, 32, **meta)
    kv = torch.empty(1, 1, 8, 32, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        flash_attention(q, kv, kv, 0, scale=1.0)
    cache = torch.empty(1, 1, 1, 8, 32, dtype=torch.int8, **meta)
    sc = torch.empty(1, 1, 1, 8, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        decode_attention_update_quantized_stacked(
            q[:, 0], kv[:, :, 0], kv[:, :, 0], cache, cache, sc, sc, 0,
            torch.ones(1, dtype=torch.int32, **meta), scale=1.0)
    pages = torch.empty(1, 1, 3, 8, 32, dtype=torch.int8, **meta)
    pscales = torch.empty(1, 3, 1, 8, **meta)
    table = torch.zeros(1, 2, dtype=torch.int32, **meta)
    lengths = torch.ones(1, dtype=torch.int32, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        paged_decode_attention_update_stacked(
            q[:, 0], kv[:, :, 0], kv[:, :, 0], pages, pages, pscales, pscales, table,
            lengths, 0, scale=1.0)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        paged_decode_attention_stacked(q[:, 0], pages, pages, pscales, pscales, table,
                                       lengths, 0, scale=1.0)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        paged_decode_attention(q[:, 0], pages[0], pages[0], pscales[0], pscales[0], table,
                               lengths, scale=1.0)
    from metalchat_tpu_torch.ops import decode_attention as dm

    dense = torch.empty(1, 1, 1, 8, 32, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        dm.decode_attention_stacked(q[:, 0], dense, dense, 0, lengths, scale=1.0)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        dm.decode_attention_quantized_stacked(q[:, 0], cache, cache, sc, sc, 0, lengths,
                                              scale=1.0)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        dm.decode_attention(q[:, 0], dense[0], dense[0], lengths, scale=1.0)
    from metalchat_tpu_torch.ops import dequant_matmul, ffn_block_stacked

    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        dequant_matmul(x, p[0], torch.empty(32, 2, **meta), bits=4, group_size=32,
                       transposed=True)
    w = torch.empty(1, 64, 32, dtype=torch.int8, **meta)
    sc = torch.empty(1, 1, 64, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ffn_block_stacked(x, x, w, sc, torch.empty(1, 64, dtype=torch.bfloat16, **meta),
                          torch.empty(1, 128, 32, dtype=torch.int8, **meta),
                          torch.empty(1, 1, 128, **meta), w, sc, 0, bits=4, act="silu",
                          eps=1e-5)


@pytest.mark.parametrize("module", [
    "metalchat_tpu_torch.cache", "metalchat_tpu_torch.engine",
    "metalchat_tpu_torch.engine.http", "metalchat_tpu_torch.engine.paged",
    "metalchat_tpu_torch.engine.serving", "metalchat_tpu_torch.ops.paged_attention",
    "metalchat_tpu_torch.ops.quant_matmul", "metalchat_tpu_torch.ops.ffn_block",
    "metalchat_tpu_torch.models.decode",
    "metalchat_tpu_torch.text.tokenizer", "metalchat_tpu_torch.utils.profiling",
    "metalchat_tpu_torch.text", "metalchat_tpu_torch.text.pretokenize",
    "metalchat_tpu_torch.chat", "metalchat_tpu_torch.chat.interpreter",
    "metalchat_tpu_torch.chat.tools", "metalchat_tpu_torch.chat.hf_template",
    "metalchat_tpu_torch.cli.main", "metalchat_tpu_torch.cli.store",
    "metalchat_tpu_torch.io.repository", "metalchat_tpu_torch.engine.speculative",
    "metalchat_tpu_torch.io.loaders", "metalchat_tpu_torch.io.safetensors",
    "metalchat_tpu_torch.quant.awq", "metalchat_tpu_torch.quant.gptq",
    "metalchat_tpu_torch.quant.checkpoint"])
def test_serving_modules_import_without_a_card(module):
    """Importing a module of the serving, text, chat, CLI, speculative,
    checkpoint or quantization-tooling slice builds and loads no kernel, so
    it needs neither nvcc nor a card."""
    import importlib

    from metalchat_tpu_torch.ops import _build

    importlib.import_module(module)
    assert _build._LIBS == {}


@pytest.mark.parametrize("module", ["metalchat_tpu_torch.text", "metalchat_tpu_torch.chat",
                                    "metalchat_tpu_torch.cli.main",
                                    "metalchat_tpu_torch.engine.speculative",
                                    "metalchat_tpu_torch.io.loaders",
                                    "metalchat_tpu_torch.quant.checkpoint",
                                    "metalchat_tpu_torch.quant.gptq"])
def test_text_chat_cli_import_no_optional_packages(module):
    """In a fresh interpreter: after the import, none of regex, jsonschema,
    jinja2, jax or metalchat_tpu is in ``sys.modules`` (jinja2 is imported
    inside the HF template render only)."""
    import subprocess
    import sys

    code = (f"import sys, {module}\n"
            "banned = ('regex', 'jsonschema', 'jinja2', 'jax', 'metalchat_tpu')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in banned))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


NATIVE_AND_TOOLS = ("native/__init__.py", "native/build.py", "tools/__init__.py",
                    "tools/quality_gate.py", "tools/quality_tp.py", "tools/train_fixture.py")


def test_native_and_tools_are_checked():
    """The native runtime and the tools are among the files
    `test_port_imports_no_jax` reads."""
    for name in NATIVE_AND_TOOLS:
        assert ROOT / "metalchat_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("module", ["metalchat_tpu_torch.native",
                                    "metalchat_tpu_torch.native.build",
                                    "metalchat_tpu_torch.tools.quality_gate",
                                    "metalchat_tpu_torch.tools.quality_tp",
                                    "metalchat_tpu_torch.tools.train_fixture"])
def test_native_and_tools_import_neither_jax_nor_the_jax_package(module):
    """In a fresh interpreter: neither jax nor metalchat_tpu is imported, and
    the native runtime imports no torch."""
    import subprocess
    import sys

    code = (f"import sys, {module}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'metalchat_tpu', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=120)
    want = "[]" if ".native" in module else "['torch']"
    assert out.stdout.strip() == want, out.stdout


def test_native_loader_opens_nothing_of_the_jax_package(monkeypatch):
    """The library loaded is the port's own build under
    metalchat_tpu_torch/build/, compiled from metalchat_tpu_torch/native/
    sources; no path under metalchat_tpu/ is loaded or compiled."""
    import ctypes

    from metalchat_tpu_torch import native
    from metalchat_tpu_torch.native import build

    loaded, real = [], ctypes.CDLL

    def recording(path, *args, **kwargs):
        loaded.append(str(path))
        return real(path, *args, **kwargs)

    monkeypatch.setattr(native.ctypes, "CDLL", recording)
    monkeypatch.setattr(native, "_LIB", None)
    native.library()
    assert loaded == [str(build.library_path())]
    assert build.library_path().parent == ROOT / "metalchat_tpu_torch" / "build"
    jax_pkg = ROOT / "metalchat_tpu"
    for path in [*loaded, *(str(build.SRC_DIR / s) for s in build.SOURCES)]:
        assert not path.startswith(str(jax_pkg) + "/"), path
    assert build.SRC_DIR == ROOT / "metalchat_tpu_torch" / "native"


@pytest.mark.parametrize("tool", ["quality_gate", "quality_tp", "train_fixture"])
def test_tools_on_the_card_without_one_raise(tool, tmp_path):
    """``--device cuda`` (each tool's default) on a machine without a card
    fails with CUDA's message before it reads or writes anything: no
    fallback to the CPU."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    argv = [sys.executable, "-m", f"metalchat_tpu_torch.tools.{tool}", "--device", "cuda"]
    if tool == "train_fixture":
        argv += ["--out", str(tmp_path / "out")]
    if tool == "quality_gate":
        argv += ["--out", str(tmp_path / "QUALITY_x")]
    before = sorted(p.name for p in ROOT.iterdir())
    out = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert sorted(p.name for p in ROOT.iterdir()) == before
    assert list(tmp_path.iterdir()) == []
