"""The port's quality gate (metalchat_tpu_torch/tools/quality_gate.py)
against the JAX functions that tools/quality_gate.py calls, on the CPU, in
f32 (XLA's CPU backend has no bf16 dot, so the JAX tool itself cannot run
here end to end).

Model: the trained fixture cut to its first 2 layers, written to a
temporary directory with 128 positions (so the long-context slice is 128
tokens); ``--batches 1 --batch 2 --seq 64``. The JAX side repeats the JAX
tool's steps in its order: the slices, the AWQ α grid scored on the
calibration batch, the three GPTQ trees, the twelve schemes, the
long-context runners, ``headline_int8kv``. Tolerances, those of
tests/test_torch_ppl.py and test_torch_gptq.py:

* bf16 (here f32) and the weight-only schemes: perplexity within 1e-5
  relative (float rounding only);
* W8A8, W4A8, clip and AWQ, with or without the int8 KV cache: the mean NLL
  within 2e-3 relative (an ulp upstream moves an int8 activation code by a
  quantum, and the flips cascade: test_torch_ppl's docstring); each α's
  calibration NLL the same;
* the GPTQ trees: perplexity within 0.5% relative (codes may differ at
  .5 boundaries after LAPACK's last ulp: test_torch_gptq's docstring);
* the slices: equal.

The module runs on one torch thread, as the other parity files do. With
more, torch's CPU build with MKL 2024.2 never returns from a batched f64
``inv_ex`` of 1024-wide matrices ("Parameter 6 was incorrect on entry to
DLASWP"): GPTQ's factor inverts one matrix at a time on the CPU, which
`test_gptq_factor_returns_on_two_cpu_threads` checks in a process of its
own.
"""

import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import SafetensorsDocument as JDocument
from metalchat_tpu.io.safetensors import save_safetensors as jsave
from metalchat_tpu.quant import awq as jawq
from metalchat_tpu.quant import ppl as jppl
from metalchat_tpu.quant.gptq import gptq_quantize_params as jgptq
from metalchat_tpu.quant.quantize import quantize_params as jquantize
from metalchat_tpu_torch.tools import quality_gate as qg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "pyllama_10m"
BATCHES, BATCH, SEQ, LAYERS, POSITIONS = 1, 2, 64, 2, 128
DENSE_RTOL, A8_NLL_RTOL, GPTQ_PPL_RTOL = 1e-5, 2e-3, 5e-3
TOLERANCE = {  # scheme → (what is compared, relative tolerance)
    "bf16": ("ppl", DENSE_RTOL), "int8_g32": ("ppl", DENSE_RTOL),
    "int4_g32": ("ppl", DENSE_RTOL), "int4_g32_clip": ("ppl", DENSE_RTOL),
    "w8a8": ("nll", A8_NLL_RTOL), "w4a8": ("nll", A8_NLL_RTOL),
    "w4a8_clip": ("nll", A8_NLL_RTOL), "w4a8_awq": ("nll", A8_NLL_RTOL),
    "w4a8_gptq": ("ppl", GPTQ_PPL_RTOL), "w4a8_gptq_refit": ("ppl", GPTQ_PPL_RTOL),
    "w4a8_awq_gptq": ("ppl", GPTQ_PPL_RTOL), "w4a8_awq_int8kv": ("nll", A8_NLL_RTOL),
}


@pytest.fixture(scope="module")
def cut_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixture_2_layers")
    doc = JDocument.open(FIXTURE / "model.safetensors")
    jsave(out / "model.safetensors",
          {n: np.asarray(doc[n]) for n in doc.keys()
           if not n.startswith("model.layers.") or int(n.split(".")[2]) < LAYERS})
    cfg = json.loads((FIXTURE / "config.json").read_text())
    cfg.update(num_hidden_layers=LAYERS, max_position_embeddings=POSITIONS)
    (out / "config.json").write_text(json.dumps(cfg))
    np.save(out / "eval_tokens.npy", np.load(FIXTURE / "eval_tokens.npy")[:20_000])
    return out


def jax_gate(fixture: Path):
    """The JAX tool's computation (tools/quality_gate.py:52-196) at this
    size in f32: (slices, α, NLL of each α, results, headline, long_ctx)."""
    jcfg = jload_config(fixture / "config.json")
    long_seq = min(1024, jcfg.max_seq_len)
    params = jload_params(JDocument.open(fixture / "model.safetensors"), jcfg,
                          dtype=jnp.float32, max_seq_len=max(SEQ, long_seq))
    ev = np.load(fixture / "eval_tokens.npy").astype(np.int32)
    n = BATCHES * BATCH * SEQ
    data = ev[:n].reshape(BATCHES, BATCH, SEQ)
    calib = jnp.asarray(ev[n:n + 8 * SEQ].reshape(8, SEQ))
    nll = jax.jit(functools.partial(jppl.token_nll, config=jcfg),
                  static_argnames=("quantized_kv",))
    stats = jawq.calibration_stats(params, jcfg, calib)
    best_alpha, best_nll, w4a8_awq, alpha_nll = 0.0, np.inf, None, {}
    for alpha in (0.1, 0.2, 0.35, 0.5):
        cand = jquantize(jawq.awq_fold(params, jcfg, stats, alpha=alpha), bits=4,
                         group_size=None, act_bits=8, clip_search=True)
        alpha_nll[alpha] = float(nll(cand, tokens=calib))
        if alpha_nll[alpha] < best_nll:
            best_alpha, best_nll, w4a8_awq = alpha, alpha_nll[alpha], cand
    schemes = {
        "bf16": (params, False),
        "int8_g32": (jquantize(params, bits=8, group_size=32), False),
        "int4_g32": (jquantize(params, bits=4, group_size=32), False),
        "int4_g32_clip": (jquantize(params, bits=4, group_size=32, clip_search=True), False),
        "w8a8": (jquantize(params, bits=8, group_size=None, act_bits=8), False),
        "w4a8": (jquantize(params, bits=4, group_size=None, act_bits=8), False),
        "w4a8_clip": (jquantize(params, bits=4, group_size=None, act_bits=8,
                                clip_search=True), False),
        "w4a8_awq": (w4a8_awq, False),
        "w4a8_gptq": (jgptq(params, jcfg, calib, bits=4), False),
        "w4a8_gptq_refit": (jgptq(params, jcfg, calib, bits=4, refit_iters=2), False),
        "w4a8_awq_gptq": (jgptq(params, jcfg, calib, bits=4, awq_alpha=best_alpha), False),
        "w4a8_awq_int8kv": (w4a8_awq, True),
    }

    def ppl(p, qkv, batches):
        return float(np.exp(np.mean([float(nll(p, tokens=jnp.asarray(b), quantized_kv=qkv))
                                     for b in batches])))

    results = {k: ppl(p, q, data) for k, (p, q) in schemes.items()}
    deltas = {k: 100.0 * (v - results["bf16"]) / results["bf16"] for k, v in results.items()}
    ranked = sorted(qg.HEADLINE_CANDIDATES, key=lambda k: results[k])
    headline = ranked[0]
    bl = max(4, BATCHES // 2)
    tail = ev[n + 8 * SEQ:]
    long = tail[:bl * BATCH * long_seq].reshape(bl, BATCH, long_seq)
    long_bf16 = ppl(params, False, long)
    top2 = {k: ppl(schemes[k][0], True, long) for k in ranked[:2]}
    d0 = 100.0 * (top2[ranked[0]] - long_bf16) / long_bf16
    d1 = 100.0 * (top2[ranked[1]] - long_bf16) / long_bf16
    if deltas[ranked[1]] - deltas[ranked[0]] <= 0.1 and d0 - d1 >= 0.2:
        headline = ranked[1]
    results["headline_int8kv"] = ppl(schemes[headline][0], True, data)
    cut = (data, np.asarray(calib), long)
    return cut, best_alpha, alpha_nll, results, headline, {"bf16": long_bf16, **top2}


@pytest.fixture(scope="module")
def gates(cut_fixture):
    params, cfg, ev, long_seq = qg.load_fixture(cut_fixture, SEQ, "cpu", torch.float32)
    cut = qg.slices(ev, BATCHES, BATCH, SEQ, long_seq)
    logs = []
    gate = qg.run_gate(params, cfg, cut, log=logs.append)
    return cut, gate, logs, jax_gate(cut_fixture)


def test_slices_equal_the_jax_tools(gates):
    cut, _, _, (want, *_) = gates
    np.testing.assert_array_equal(cut.data, want[0])
    np.testing.assert_array_equal(cut.calib, want[1])
    np.testing.assert_array_equal(cut.long, want[2])
    assert cut.long_seq == POSITIONS and cut.long.shape == (4, BATCH, POSITIONS)
    assert cut.data.dtype == cut.calib.dtype == np.int32


def test_awq_alpha_matches_jax(gates):
    _, gate, logs, (_, alpha, alpha_nll, *_) = gates
    assert list(gate.alpha_nll) == list(alpha_nll) == list(qg.AWQ_ALPHAS)
    for a, want in alpha_nll.items():
        np.testing.assert_allclose(gate.alpha_nll[a], want, rtol=A8_NLL_RTOL)
    assert gate.awq_alpha == alpha
    assert f"awq alpha -> {alpha}" in logs


def test_every_scheme_matches_jax_in_the_tools_order(gates):
    _, gate, _, (_, _, _, results, headline, _) = gates
    assert list(gate.results) == list(results)  # the twelve, then headline_int8kv
    assert list(gate.schemes) == list(results)
    for name, (what, rtol) in {**TOLERANCE, "headline_int8kv": TOLERANCE[
            "w4a8_awq_int8kv" if "gptq" not in headline else "w4a8_gptq"]}.items():
        got, want = gate.results[name], results[name]
        if what == "nll":
            got, want = math.log(got), math.log(want)
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    assert gate.headline == headline
    assert gate.tokens_scored == BATCHES * BATCH * (SEQ - 1)


def test_long_context_matches_jax(gates):
    _, gate, _, (*_, headline, long) = gates
    assert gate.long_seq == POSITIONS
    np.testing.assert_allclose(gate.long_ctx["bf16"], long["bf16"], rtol=DENSE_RTOL)
    assert set(gate.long_ctx["runner_up"]) == set(long) - {"bf16"}
    np.testing.assert_allclose(gate.long_ctx["headline_int8kv"], long[headline],
                               rtol=GPTQ_PPL_RTOL)


def test_record_has_quality_json_keys(gates):
    _, gate, _, _ = gates
    got = qg.record(gate, "tests/fixtures/pyllama_10m")
    want = json.loads((ROOT / "QUALITY.json").read_text())
    assert list(got) == list(want)
    assert list(got["ppl"]) == list(want["ppl"]) == list(got["ppl_delta_pct"])
    assert list(got["long_context"]) == list(want["long_context"])
    assert got["headline_ppl_delta_pct"] == got["ppl_delta_pct"]["headline_int8kv"]
    text = qg.markdown(gate, "tests/fixtures/pyllama_10m", "CPU", "")
    assert "Measured on: CPU" in text and "← headline" in text and "TPU" not in text


def _table(**ppl):
    base = {k: 2.5 for k in qg.HEADLINE_CANDIDATES}
    return {"bf16": 2.0, **base, **ppl}


def test_headline_tiebreak_both_branches():
    """tools/quality_gate.py:159-168 on hand-made tables: the runner-up
    takes the headline only when it is within 0.1 points short and at least
    0.2 points better long."""
    results = _table(w4a8_gptq_refit=2.020, w4a8_gptq=2.021, w4a8=2.2)
    deltas = qg.deltas_of(results)
    ranked = qg.rank_candidates(results)
    assert ranked[:2] == ["w4a8_gptq_refit", "w4a8_gptq"]
    flip = {"w4a8_gptq_refit": 4.10, "w4a8_gptq": 4.08}  # 0.5 points better long
    assert qg.tiebreak(ranked, deltas, 4.0, flip, log=lambda s: None) == "w4a8_gptq"
    near = {"w4a8_gptq_refit": 4.10, "w4a8_gptq": 4.095}  # 0.125 points: stays
    assert qg.tiebreak(ranked, deltas, 4.0, near, log=lambda s: None) == "w4a8_gptq_refit"
    far = _table(w4a8_gptq_refit=2.020, w4a8_gptq=2.030)  # 0.5 points short: stays
    assert qg.tiebreak(qg.rank_candidates(far), qg.deltas_of(far), 4.0, flip,
                       log=lambda s: None) == "w4a8_gptq_refit"


def test_default_output_is_not_the_jax_record(monkeypatch):
    args = qg.parse_args([])
    assert args.out == "QUALITY_torch" and args.device == "cuda"
    assert (args.batches, args.batch, args.seq) == (24, 16, 512)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("QUALITY", "QUALITY_50m"):
        with pytest.raises(SystemExit, match="JAX package's record"):
            qg.main(["--out", name])


GPTQ_FACTOR_ON_TWO_THREADS = """
import torch
from metalchat_tpu_torch.quant.gptq import _Factor
g = torch.Generator().manual_seed(0)
a = torch.randn(2, 1024, 1024, dtype=torch.float64, generator=g)
h = a @ a.mT
torch.set_num_threads(2)
u = _Factor(h, act_order=True, damp=0.01).u
torch.set_num_threads(1)
want = _Factor(h, act_order=True, damp=0.01).u
print(((u - want).abs().max() / want.abs().max()).item())
"""


def test_gptq_factor_returns_on_two_cpu_threads():
    """GPTQ's factor of a layer chunk's two 1024-wide Hessians on two torch
    threads returns (a batched f64 inverse there never does on torch's CPU
    build with MKL 2024.2), within 1e-12 of the one-thread factor's largest
    entry (MKL's threaded blocking moves the last f64 bits: 6.5e-15 here).
    In a process of its own, so a hang fails on the timeout instead of
    stalling the run."""
    out = subprocess.run([sys.executable, "-c", GPTQ_FACTOR_ON_TWO_THREADS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert float(out.stdout) <= 1e-12
