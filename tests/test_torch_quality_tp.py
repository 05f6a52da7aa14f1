"""The port's tensor-parallel quality check
(metalchat_tpu_torch/tools/quality_tp.py) against the JAX package on the
CPU: two gloo ranks spawned by the tool, ``--batch 2 --seq 64 --window
16`` on the trained fixture (tests/fixtures/pyllama_10m; the JAX tool's
default 50m fixture is not in the repository).

The fixture's 3 kv-heads are repeated to 6 for the tensor-parallel decode
(both packages' fast decode refuses 3 kv-heads over 2 ranks): the JAX side
repeats them in its own tree here, and the repeated tree's one-process
perplexity must equal the original's (the same function). The JAX side is
a copy of tools/quality_tp.py's ``decode_nll`` over ``decode_step`` and,
for tp 2, ``make_tp_decode_step`` on two of the 8 CPU devices, on the same
W4A8 tree (f32 activations and scales). Tolerance:
each mean NLL within 2e-3 relative (W4A8: an ulp upstream moves an int8
activation code by a quantum, and the flips cascade; tests/test_torch_ppl.py's
docstring). The tool's own change, tp 2 against one process, is printed by
the tool and not held: per-shard scales may round either way.
"""

from pathlib import Path

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metalchat_tpu.cache import QuantizedKVCache as JQuantizedKVCache
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models.decode import decode_step as jdecode_step
from metalchat_tpu.parallel.mesh import make_mesh as jmake_mesh
from metalchat_tpu.parallel.mesh import shard_cache as jshard_cache
from metalchat_tpu.parallel.mesh import shard_params as jshard_params
from metalchat_tpu.parallel.tp_decode import make_tp_decode_step as jmake_tp_decode_step
from metalchat_tpu.quant.quantize import quantize_params as jquantize
from metalchat_tpu_torch.tools import quality_tp as qt

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
BATCH, SEQ, WINDOW = 2, 64, 16
A8_NLL_RTOL = 2e-3


def jax_nlls():
    """(one device's NLL, tp 2's NLL): tools/quality_tp.py:59-107 at this
    size."""
    cfg = jload_config(FIXTURE / "config.json")
    params = jload_params(jopen(FIXTURE), cfg, dtype=jnp.float32, max_seq_len=SEQ)
    assert cfg.num_kv_heads == 3 and cfg.num_heads == 6
    layers = dict(params["layers"])
    for name in ("wk", "wv"):  # [L, in, 3 * hd] -> [L, in, 6 * hd], each head twice
        w = np.asarray(layers[name])
        w = w.reshape(*w.shape[:-1], 3, cfg.head_dim)
        layers[name] = jnp.asarray(np.repeat(w, 2, axis=-2).reshape(*w.shape[:-2], -1))
    params = {**params, "layers": layers}
    cfg = dataclasses.replace(cfg, num_kv_heads=6)
    qparams = jquantize(params, bits=4, group_size=None, act_bits=8, scales_dtype=jnp.float32)
    ev = np.load(FIXTURE / "eval_tokens.npy").astype(np.int32)
    data = jnp.asarray(ev[:BATCH * SEQ].reshape(BATCH, SEQ))
    mesh = jmake_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    sq = jshard_params(qparams, cfg, mesh)

    def decode_nll(step, p, cache):  # tools/quality_tp.py:77-94
        total, count = 0.0, 0
        for t0 in range(0, SEQ - 1, WINDOW):
            toks = data[:, t0:t0 + WINDOW]
            pos = jnp.full((BATCH,), t0, jnp.int32)
            logits, cache = step(p, cache, toks, pos)
            logp = jax.nn.log_softmax(np.asarray(logits, np.float32), axis=-1)
            hi = min(t0 + WINDOW, SEQ - 1)
            tgt = np.asarray(data[:, t0 + 1:hi + 1])
            k = tgt.shape[1]
            rows = np.arange(BATCH)[:, None]
            cols = np.arange(k)[None, :]
            total += float(np.sum(logp[rows, cols, tgt]))
            count += BATCH * k
        return -total / count

    single = jax.jit(lambda p, c, t, s: jdecode_step(p, c, t, s, cfg))
    nll_1 = decode_nll(single, qparams, JQuantizedKVCache.create(cfg, BATCH, SEQ))
    tp_step = jax.jit(jmake_tp_decode_step(sq, cfg, mesh))
    nll_2 = decode_nll(tp_step, sq, jshard_cache(JQuantizedKVCache.create(cfg, BATCH, SEQ),
                                                 mesh))
    return nll_1, nll_2


@pytest.fixture(scope="module")
def measured():
    logs = []
    got = qt.measure(FIXTURE, BATCH, SEQ, WINDOW, "cpu", log=logs.append)
    return got, logs, jax_nlls()


def test_single_process_matches_jax(measured):
    got, logs, (want, _) = measured
    np.testing.assert_allclose(np.log(got["decode_path_ppl_single"]), want, rtol=A8_NLL_RTOL)
    assert got["tokens_scored"] == BATCH * (SEQ - 1)
    assert logs[0].startswith("single-process decode-path w4a8: ppl")


def test_tp2_ranks_match_jax(measured):
    got, logs, (_, want) = measured
    np.testing.assert_allclose(np.log(got["decode_path_ppl_tp2"]), want, rtol=A8_NLL_RTOL)
    delta = 100.0 * (got["decode_path_ppl_tp2"] - got["decode_path_ppl_single"]) \
        / got["decode_path_ppl_single"]
    np.testing.assert_allclose(got["tp2_vs_single_pct"], delta, rtol=1e-12)
    assert any(line.startswith("tp2 vs single process:") for line in logs)


def test_repeated_kv_heads_are_the_same_function():
    """The one-process perplexity of the tree with its kv-heads repeated
    equals the original 3-kv-head tree's (plain path: the same arithmetic
    per head), and a tree that tp divides comes back as it is."""
    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.quant.quantize import quantize_params

    cfg = load_config(FIXTURE / "config.json")
    dense = load_params(open_safetensors(FIXTURE), cfg, dtype=torch.float32, max_seq_len=SEQ,
                        device="cpu")
    data = qt.eval_batch(np.load(FIXTURE / "eval_tokens.npy"), BATCH, SEQ)
    q = dict(bits=4, group_size=None, act_bits=8, scales_dtype=torch.float32)
    want = qt.single_nll(quantize_params(dense, **q), cfg, data, WINDOW)
    rep, rcfg = qt.repeat_kv_heads(dense, cfg)
    assert rcfg.num_kv_heads == 6 and rep["layers"]["wk"].shape[-1] == 6 * cfg.head_dim
    np.testing.assert_allclose(qt.single_nll(quantize_params(rep, **q), rcfg, data, WINDOW),
                               want, rtol=1e-6)
    again, acfg = qt.repeat_kv_heads(rep, rcfg)
    assert again is rep and acfg is rcfg


def test_the_window_must_divide_seq():
    with pytest.raises(ValueError, match="multiple of the window"):
        qt.decode_nll(None, {"final_norm": torch.zeros(1)}, None, np.zeros((1, 20), np.int32),
                      16)


def test_defaults_and_record(monkeypatch, tmp_path):
    args = qt.parse_args([])
    assert (args.batch, args.seq, args.window, args.device) == (16, 512, 16, "cuda")
    assert args.fixture == "tests/fixtures/pyllama_10m" and qt.RECORD == "QUALITY_torch.json"
    # main adds its block to the port's record where it exists, nothing else.
    (tmp_path / "QUALITY_torch.json").write_text('{"headline_scheme": "w4a8"}')
    monkeypatch.setattr(qt, "ROOT", tmp_path)
    monkeypatch.setattr(qt, "measure", lambda *a, **k: {
        "decode_path_ppl_single": 2.0, "decode_path_ppl_tp2": 2.001,
        "tp2_vs_single_pct": 0.05, "tokens_scored": 10})
    qt.main(["--device", "cpu", "--fixture", str(FIXTURE)])
    blob = __import__("json").loads((tmp_path / "QUALITY_torch.json").read_text())
    assert blob["headline_scheme"] == "w4a8" and blob["w4a8_tp2"]["device"] == "CPU"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["QUALITY_torch.json"]
