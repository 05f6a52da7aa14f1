"""Quality gate: the perplexity change against bf16 of every quantization
scheme, on the trained fixture's held-out eval corpus (the port of the JAX
package's ``tools/quality_gate.py``).

Twelve schemes of one parameter tree: weight-only int8/int4 group 32 (int4
with and without the clip search), W8A8, W4A8 (plain, clip search, AWQ with
α searched over 0.1/0.2/0.35/0.5 on the calibration batch, GPTQ, GPTQ with
two scale refits, AWQ + GPTQ) and AWQ with the int8 KV cache; then the
headline (the best W4A8 scheme by perplexity, with a long-context
tiebreak) re-measured with the int8 KV cache. The record has
``QUALITY.json``'s keys.

Run:  python -m metalchat_tpu_torch.tools.quality_gate [--batches 24]
      [--batch 16] [--seq 512] [--fixture tests/fixtures/pyllama_10m]
      [--out QUALITY_torch] [--device cuda]

Writes ``<out>.json`` and ``<out>.md`` at the repository root
(``QUALITY_torch`` by default; the JAX package's ``QUALITY.json`` is not
this tool's). On the card the ``.md`` names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.config import ModelConfig, load_config
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.quant.awq import awq_fold, calibration_stats
from metalchat_tpu_torch.quant.gptq import gptq_quantize_params
from metalchat_tpu_torch.quant.ppl import token_nll
from metalchat_tpu_torch.quant.quantize import quantize_params

ROOT = Path(__file__).resolve().parent.parent.parent
FIXTURE = "tests/fixtures/pyllama_10m"
CALIB_ROWS = 8
AWQ_ALPHAS = (0.1, 0.2, 0.35, 0.5)
# The headline is the best int4-weight, int8-activation scheme (what the
# bench runs).
HEADLINE_CANDIDATES = ("w4a8", "w4a8_clip", "w4a8_awq", "w4a8_gptq", "w4a8_gptq_refit",
                       "w4a8_awq_gptq")
Log = Callable[[str], None]


@dataclass
class Slices:
    """The eval corpus cut as the JAX tool cuts it: ``data`` [batches,
    batch, seq] from the start, ``calib`` [8, seq] right after, ``long``
    [max(4, batches // 2), batch, long_seq] after that (None when the
    corpus is short or long_seq is not longer than seq)."""
    data: np.ndarray
    calib: np.ndarray
    long: Optional[np.ndarray]
    long_seq: int


def slices(ev: np.ndarray, batches: int, batch: int, seq: int, long_seq: int) -> Slices:
    ev = ev.astype(np.int32)
    n = batches * batch * seq
    if len(ev) < n:
        raise SystemExit(f"eval corpus too small: {len(ev)} < {n}")
    data = ev[:n].reshape(batches, batch, seq)
    calib = ev[n:n + CALIB_ROWS * seq].reshape(CALIB_ROWS, seq)
    bl = max(4, batches // 2)
    need = bl * batch * long_seq
    tail = ev[n + CALIB_ROWS * seq:]
    long = (tail[:need].reshape(bl, batch, long_seq)
            if long_seq > seq and len(tail) >= need else None)
    return Slices(data, calib, long, long_seq)


def _tokens(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def perplexity_over(params, cfg: ModelConfig, batches: np.ndarray,
                    quantized_kv: bool = False) -> float:
    """exp of the mean of `token_nll` over the batches (the JAX tool's
    scoring)."""
    device = params["final_norm"].device
    vals = [float(token_nll(params, cfg, _tokens(b, device), quantized_kv=quantized_kv))
            for b in batches]
    return float(np.exp(np.mean(vals)))


def search_awq_alpha(params, cfg: ModelConfig, calib: np.ndarray,
                     log: Log = print) -> Tuple[float, Dict, Dict[float, float]]:
    """AWQ's α over `AWQ_ALPHAS`, each folded and W4A8-quantized with the
    clip search and scored by its NLL on the calibration batch itself (the
    AWQ paper's protocol). Returns (α, its tree, the NLL of each α)."""
    tokens = _tokens(calib, params["final_norm"].device)
    stats = calibration_stats(params, cfg, tokens)
    best_alpha, best_nll, best, table = 0.0, np.inf, None, {}
    for alpha in AWQ_ALPHAS:
        cand = quantize_params(awq_fold(params, cfg, stats, alpha=alpha), bits=4,
                               group_size=None, act_bits=8, clip_search=True)
        nll = float(token_nll(cand, cfg, tokens))
        table[alpha] = nll
        log(f"  awq alpha={alpha}: calib nll {nll:.5f}")
        if nll < best_nll:
            best_alpha, best_nll, best = alpha, nll, cand
    log(f"awq alpha -> {best_alpha}")
    return best_alpha, best, table


def candidates(params, cfg: ModelConfig, calib: np.ndarray,
               log: Log = print) -> Tuple[Dict[str, Tuple[Dict, bool]], float, Dict]:
    """The twelve schemes in the JAX tool's order, name → (tree, int8 KV),
    the calibrated ones calibrated on ``calib``; also the AWQ α and the
    NLL of each α."""
    alpha, w4a8_awq, alpha_nll = search_awq_alpha(params, cfg, calib, log)
    tokens = _tokens(calib, params["final_norm"].device)
    t0 = time.perf_counter()
    w4a8_gptq = gptq_quantize_params(params, cfg, tokens, bits=4)
    w4a8_awq_gptq = gptq_quantize_params(params, cfg, tokens, bits=4, awq_alpha=alpha)
    # The Hessian scale refit: round, refit the scales by least squares,
    # round again, refit once more.
    w4a8_gptq_refit = gptq_quantize_params(params, cfg, tokens, bits=4, refit_iters=2)
    log(f"gptq quantization: {time.perf_counter() - t0:.1f}s")
    schemes = {
        "bf16": (params, False),
        "int8_g32": (quantize_params(params, bits=8, group_size=32), False),
        "int4_g32": (quantize_params(params, bits=4, group_size=32), False),
        "int4_g32_clip": (quantize_params(params, bits=4, group_size=32, clip_search=True),
                          False),
        "w8a8": (quantize_params(params, bits=8, group_size=None, act_bits=8), False),
        "w4a8": (quantize_params(params, bits=4, group_size=None, act_bits=8), False),
        "w4a8_clip": (quantize_params(params, bits=4, group_size=None, act_bits=8,
                                      clip_search=True), False),
        "w4a8_awq": (w4a8_awq, False),
        "w4a8_gptq": (w4a8_gptq, False),
        "w4a8_gptq_refit": (w4a8_gptq_refit, False),
        "w4a8_awq_gptq": (w4a8_awq_gptq, False),
        "w4a8_awq_int8kv": (w4a8_awq, True),
    }
    return schemes, alpha, alpha_nll


def score(schemes: Dict[str, Tuple[Dict, bool]], cfg: ModelConfig, data: np.ndarray,
          log: Log = print) -> Dict[str, float]:
    """Each scheme's perplexity over ``data``."""
    results = {}
    for name, (p, qkv) in schemes.items():
        t0 = time.perf_counter()
        results[name] = perplexity_over(p, cfg, data, qkv)
        log(f"{name:14s} ppl {results[name]:.4f}   ({time.perf_counter() - t0:.1f}s)")
    return results


def deltas_of(results: Dict[str, float]) -> Dict[str, float]:
    ref = results["bf16"]
    return {k: 100.0 * (v - ref) / ref for k, v in results.items()}


def rank_candidates(results: Dict[str, float]) -> List[str]:
    return sorted(HEADLINE_CANDIDATES, key=lambda k: results[k])


def tiebreak(ranked: List[str], deltas: Dict[str, float], long_bf16: float,
             top2_long: Dict[str, float], log: Log = print) -> str:
    """The headline given the runners' long-context perplexities (int8 KV):
    the runner-up wins when it is within noise at short context (at most
    0.1 points of delta behind) and materially better at long context (at
    least 0.2 points ahead); else the short-context winner."""
    d0 = 100.0 * (top2_long[ranked[0]] - long_bf16) / long_bf16
    d1 = 100.0 * (top2_long[ranked[1]] - long_bf16) / long_bf16
    short_gap = deltas[ranked[1]] - deltas[ranked[0]]
    if short_gap <= 0.1 and d0 - d1 >= 0.2:
        log(f"long-context tiebreak: {ranked[1]} (+{short_gap:.3f}% short) beats "
            f"{ranked[0]} at long context ({d1:+.3f}% vs {d0:+.3f}%) -> headline flips")
        return ranked[1]
    return ranked[0]


@dataclass
class Gate:
    """Everything the gate measured."""
    results: Dict[str, float]
    deltas: Dict[str, float]
    schemes: Dict[str, Tuple[Dict, bool]]
    headline: str
    awq_alpha: float
    alpha_nll: Dict[float, float]
    tokens_scored: int
    long_ctx: Dict = field(default_factory=dict)
    long_seq: int = 0


def run_gate(params, cfg: ModelConfig, cut: Slices, log: Log = print) -> Gate:
    """Score every scheme, pick the headline (with the long-context
    tiebreak where the corpus holds the long slice) and re-measure it with
    the int8 KV cache (``headline_int8kv``)."""
    schemes, alpha, alpha_nll = candidates(params, cfg, cut.calib, log)
    results = score(schemes, cfg, cut.data, log)
    deltas = deltas_of(results)
    ranked = rank_candidates(results)
    headline = ranked[0]
    long_ctx: Dict = {}
    top2_long: Dict[str, float] = {}
    if cut.long is not None:
        long_bf16 = perplexity_over(params, cfg, cut.long)
        top2_long = {k: perplexity_over(schemes[k][0], cfg, cut.long, True)
                     for k in ranked[:2]}
        headline = tiebreak(ranked, deltas, long_bf16, top2_long, log)
    best = schemes[headline][0]
    results["headline_int8kv"] = perplexity_over(best, cfg, cut.data, True)
    schemes["headline_int8kv"] = (best, True)
    deltas["headline_int8kv"] = 100.0 * (results["headline_int8kv"] - results["bf16"]) \
        / results["bf16"]
    log(f"{'headline_int8kv':14s} ppl {results['headline_int8kv']:.4f}")
    if cut.long is not None:
        long_ctx["bf16"] = long_bf16
        long_ctx["headline_int8kv"] = (top2_long.get(headline)
                                       or perplexity_over(best, cfg, cut.long, True))
        long_ctx["delta_pct"] = round(100.0 * (long_ctx["headline_int8kv"] - long_bf16)
                                      / long_bf16, 4)
        long_ctx["runner_up"] = {k: round(100.0 * (v - long_bf16) / long_bf16, 4)
                                 for k, v in top2_long.items()}
        log(f"long-context ({cut.long_seq} tokens): bf16 {long_bf16:.4f}  headline_int8kv "
            f"{long_ctx['headline_int8kv']:.4f}  delta {long_ctx['delta_pct']:+.3f}%")
    b, rows, seq = cut.data.shape
    return Gate(results, deltas, schemes, headline, alpha, alpha_nll, b * rows * (seq - 1),
                long_ctx, cut.long_seq)


def record(gate: Gate, fixture: str) -> Dict:
    """The quality record, with QUALITY.json's keys."""
    quality = {
        "fixture": fixture,
        "eval_tokens": gate.tokens_scored,
        "ppl": {k: round(v, 5) for k, v in gate.results.items()},
        "ppl_delta_pct": {k: round(v, 4) for k, v in gate.deltas.items()},
        "headline_scheme": gate.headline,
        # What ships is the headline's weights with the int8 KV cache.
        "headline_ppl_delta_pct": round(gate.deltas["headline_int8kv"], 4),
        "headline_weights_only_delta_pct": round(gate.deltas[gate.headline], 4),
        "awq_alpha": gate.awq_alpha,
    }
    if gate.long_ctx:
        quality["long_context"] = {"seq": gate.long_seq, **{
            k: (round(v, 5) if isinstance(v, float) else v) for k, v in gate.long_ctx.items()}}
    return quality


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them (on the
    CPU: "CPU")."""
    if device.type != "cuda":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def markdown(gate: Gate, fixture: str, measured_on: str, argv: str) -> str:
    lines = [
        "# Quality gate of the PyTorch/CUDA port — perplexity Δ vs bf16",
        "",
        f"Measured on: {measured_on} (`python -m metalchat_tpu_torch.tools.quality_gate"
        f"{argv}`).",
        f"Corpus: held-out byte-level Python ({gate.tokens_scored:,} tokens scored),",
        f"model: `{fixture}` (a trained ~10M-param Llama, tools/train_fixture.py).",
        "",
        "| scheme | ppl | Δ vs bf16 |",
        "|---|---|---|",
    ]
    for k in gate.schemes:
        mark = " ← headline" if k == gate.headline else ""
        lines.append(f"| {k} | {gate.results[k]:.4f} | {gate.deltas[k]:+.3f}%{mark} |")
    if gate.long_ctx:
        lines += ["", f"Long context ({gate.long_seq} tokens, headline weights + int8 KV): "
                      f"ppl {gate.long_ctx['headline_int8kv']:.4f} vs bf16 "
                      f"{gate.long_ctx['bf16']:.4f} — Δ {gate.long_ctx['delta_pct']:+.3f}%."]
    lines += [
        "",
        f"AWQ α {gate.awq_alpha} (calibration NLL by α: "
        + ", ".join(f"{a}: {v:.5f}" for a, v in gate.alpha_nll.items()) + ").",
        "",
        "Schemes: `int{8,4}_g32` = weight-only group-32; `w{8,4}a8` = per-channel",
        "weights with dynamic per-token int8 activations; `_clip` = MSE-optimal clip",
        "search instead of absmax scales; `_awq` = activation-aware scale folding +",
        "clip; `_gptq` = Hessian-compensated rounding (`_refit`: two least-squares",
        "scale refits); `_int8kv` adds the int8 KV cache.",
    ]
    return "\n".join(lines) + "\n"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m metalchat_tpu_torch.tools.quality_gate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", default=FIXTURE)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out", default="QUALITY_torch",
                    help="output base name at the repository root (QUALITY_torch -> "
                         "QUALITY_torch.json/.md)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def load_fixture(fixture, seq: int, device, dtype=torch.bfloat16):
    """(params of ``dtype`` on ``device`` with rope tables for the long
    slice, config, eval tokens, long_seq) of a fixture directory."""
    fixture = Path(fixture)
    cfg = load_config(fixture / "config.json")
    long_seq = min(1024, cfg.max_seq_len)
    params = load_params(open_safetensors(fixture / "model.safetensors"), cfg, dtype=dtype,
                         max_seq_len=max(seq, long_seq), device=device)
    return params, cfg, np.load(fixture / "eval_tokens.npy"), long_seq


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.out in ("QUALITY", "QUALITY_50m"):
        raise SystemExit(f"{args.out}.json is the JAX package's record; pick another --out")
    fixture = Path(args.fixture)
    params, cfg, ev, long_seq = load_fixture(fixture if fixture.is_absolute() else ROOT / fixture,
                                             args.seq, device)
    gate = run_gate(params, cfg, slices(ev, args.batches, args.batch, args.seq, long_seq))
    quality = record(gate, args.fixture)
    with open(ROOT / f"{args.out}.json", "w") as fh:
        json.dump(quality, fh, indent=1)
    flags = f" --batches {args.batches} --batch {args.batch} --seq {args.seq}"
    with open(ROOT / f"{args.out}.md", "w") as fh:
        fh.write(markdown(gate, args.fixture, device_line(device), flags))
    print(json.dumps(quality))
    return quality


if __name__ == "__main__":
    main()
