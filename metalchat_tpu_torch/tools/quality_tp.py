"""Tensor-parallel numerics: teacher-forced perplexity through the decode
path, once in one process and once over two tensor-parallel ranks (the
port of the JAX package's ``tools/quality_tp.py``).

The tensor-parallel decode (`parallel.tp_decode`) quantizes the
activations of each row-parallel matvec per shard, where one process
quantizes per token: this measures what that does to perplexity. Same
W4A8 weights (f32 scales, f32 activations), same eval tokens, fed in
windows of ``--window`` tokens through `models.decode.decode_step` into an
int8 KV cache; the two ranks are processes of their own over gloo (a
``file://`` rendezvous in a temporary directory), on the same device.

The fast decode splits the kv-heads over the ranks, so it refuses a model
whose kv-heads tp does not divide (in both packages). The committed fixture
has 3 (the JAX tool's default 50m fixture, with 4, is not in the
repository): such a tree has each kv-head repeated (`repeat_kv_heads`, 3 →
6) before it is quantized. That is the same function: query head h reads
a copy of the kv-head it read before, whose int8 codes and scales are the
same.

Run:  python -m metalchat_tpu_torch.tools.quality_tp [--fixture
      tests/fixtures/pyllama_10m] [--batch 16] [--seq 512] [--window 16]
      [--device cuda]

Adds a ``w4a8_tp2`` block to ``QUALITY_torch.json`` when that file exists
(the JAX package's ``QUALITY_50m.json`` is not this tool's).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.cache import QuantizedKVCache
from metalchat_tpu_torch.config import ModelConfig, load_config
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.models.decode import decode_step
from metalchat_tpu_torch.quant.quantize import quantize_params
from metalchat_tpu_torch.tools.quality_gate import device_line

ROOT = Path(__file__).resolve().parent.parent.parent
FIXTURE = "tests/fixtures/pyllama_10m"
RECORD = "QUALITY_torch.json"
TP = 2
RANK_TIMEOUT_S = 900


def repeat_kv_heads(params: dict, cfg: ModelConfig, tp: int = TP) -> Tuple[dict, ModelConfig]:
    """A dense tree and config whose kv-heads ``tp`` divides: each kv-head of
    wk and wv repeated f times in place (the least f for which tp divides
    the count and the count divides the query heads), the same function.
    A tree whose kv-heads tp divides comes back as it is."""
    nkv, nh, hd = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    f = next((f for f in range(1, nh // nkv + 1) if (nkv * f) % tp == 0 and nh % (nkv * f) == 0),
             None)
    if f is None:
        raise ValueError(f"no repetition of {nkv} kv-heads divides by tp={tp} and divides "
                         f"{nh} query heads")
    if f == 1:
        return params, cfg
    layers = dict(params["layers"])
    for name in ("wk", "wv"):
        w = layers[name]  # [L, in, nkv * hd]
        layers[name] = (w.reshape(*w.shape[:-1], nkv, hd).repeat_interleave(f, dim=-2)
                        .reshape(*w.shape[:-1], nkv * f * hd).contiguous())
    return {**params, "layers": layers}, cfg.replace(num_kv_heads=nkv * f)


def load_w4a8(fixture, seq: int, device) -> Tuple[dict, ModelConfig, np.ndarray]:
    """(the fixture's W4A8 tree, f32 activations and scales, on ``device``,
    its kv-heads repeated where tp does not divide them; its config; its
    eval tokens)."""
    fixture = Path(fixture)
    cfg = load_config(fixture / "config.json")
    params = load_params(open_safetensors(fixture / "model.safetensors"), cfg,
                         dtype=torch.float32, max_seq_len=seq, device=device)
    params, cfg = repeat_kv_heads(params, cfg)
    qparams = quantize_params(params, bits=4, group_size=None, act_bits=8,
                              scales_dtype=torch.float32)
    return qparams, cfg, np.load(fixture / "eval_tokens.npy")


def eval_batch(ev: np.ndarray, batch: int, seq: int) -> np.ndarray:
    return ev[:batch * seq].astype(np.int32).reshape(batch, seq)


def decode_nll(step: Callable, params, cache, data: np.ndarray, window: int) -> float:
    """Teacher-forced NLL of ``data`` [B, S] through ``window``-token
    decode windows: ``step(params, cache, tokens, positions)``; each
    window's positions score the next token (the final window's last
    position has none)."""
    batch, seq = data.shape
    if seq % window:
        raise ValueError(f"seq {seq} is not a multiple of the window {window}")
    device = params["final_norm"].device
    tokens = torch.from_numpy(data).to(device)
    total, count = 0.0, 0
    for t0 in range(0, seq - 1, window):
        pos = torch.full((batch,), t0, dtype=torch.int32, device=device)
        logits, cache = step(params, cache, tokens[:, t0:t0 + window], pos)
        logp = torch.log_softmax(logits.float(), dim=-1)
        hi = min(t0 + window, seq - 1)
        tgt = tokens[:, t0 + 1:hi + 1].long()
        total += float(logp[:, :tgt.shape[1]].gather(-1, tgt[..., None]).sum())
        count += batch * tgt.shape[1]
    return -total / count


def single_nll(qparams, cfg: ModelConfig, data: np.ndarray, window: int) -> float:
    """`decode_nll` of the whole tree in this process."""
    device = qparams["final_norm"].device
    cache = QuantizedKVCache.create(cfg, data.shape[0], data.shape[1], device=device)
    return decode_nll(lambda p, c, t, s: decode_step(p, c, t, s, cfg), qparams, cache, data,
                      window)


def tp_rank(rank: int, store: str, out: str, fixture: str, batch: int, seq: int,
            window: int, device: str) -> None:
    """One rank of `tp_nll`, a process of its own: joins the gloo group,
    shards the W4A8 tree and the int8 cache, runs `decode_nll` through the
    tensor-parallel step; rank 0 writes the NLL to ``out``."""
    from metalchat_tpu_torch.parallel import (
        initialize,
        make_mesh,
        make_tp_decode_step,
        shard_cache,
        shard_params,
        shutdown,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    initialize(f"file://{store}", TP, rank, backend="gloo", timeout_s=RANK_TIMEOUT_S)
    try:
        dev = resolve_device(device)
        qparams, cfg, ev = load_w4a8(fixture, seq, dev)
        mesh = make_mesh(tp=TP)
        local = shard_params(qparams, cfg, mesh)
        del qparams
        cache = shard_cache(QuantizedKVCache.create(cfg, batch, seq, device=dev), mesh)
        nll = decode_nll(make_tp_decode_step(local, cfg, mesh), local, cache,
                         eval_batch(ev, batch, seq), window)
        if rank == 0:
            Path(out).write_text(json.dumps({"nll": nll}))
    finally:
        shutdown()


def tp_nll(fixture, batch: int, seq: int, window: int, device: str,
           timeout_s: float = RANK_TIMEOUT_S) -> float:
    """`decode_nll` over `TP` ranks, each a spawned process running
    `tp_rank`; raises if a rank fails or outlives ``timeout_s`` (it is
    killed)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="quality_tp_") as tmp:
        out = f"{tmp}/nll.json"
        procs = [ctx.Process(target=tp_rank, args=(r, f"{tmp}/store", out, str(fixture), batch,
                                                   seq, window, device))
                 for r in range(TP)]
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if hung:
            raise RuntimeError(f"quality_tp: ranks {hung} still running after {timeout_s} s "
                               "(killed)")
        codes = [p.exitcode for p in procs]
        if codes != [0] * TP:
            raise RuntimeError(f"quality_tp: rank exit codes {codes}")
        return json.loads(Path(out).read_text())["nll"]


def measure(fixture, batch: int, seq: int, window: int, device: str,
            log: Optional[Callable[[str], None]] = print) -> dict:
    """Both perplexities and the tp-2 change, in the record's keys."""
    dev = resolve_device(device)
    qparams, cfg, ev = load_w4a8(fixture, seq, dev)
    ppl_1 = float(np.exp(single_nll(qparams, cfg, eval_batch(ev, batch, seq), window)))
    del qparams
    if log:
        log(f"single-process decode-path w4a8: ppl {ppl_1:.4f}")
    ppl_2 = float(np.exp(tp_nll(fixture, batch, seq, window, device)))
    delta = 100.0 * (ppl_2 - ppl_1) / ppl_1
    if log:
        log(f"tp=2 per-shard act-quant:        ppl {ppl_2:.4f}")
        log(f"tp2 vs single process: {delta:+.4f}%  "
            f"({'never-coarser holds' if delta <= 0.05 else 'REGRESSION'})")
    return {"decode_path_ppl_single": ppl_1, "decode_path_ppl_tp2": ppl_2,
            "tp2_vs_single_pct": delta, "tokens_scored": batch * (seq - 1)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m metalchat_tpu_torch.tools.quality_tp",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", default=FIXTURE)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--window", type=int, default=16,
                    help="teacher-forced tokens a decode step (at most 16: the decode "
                         "path's multi-token window)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    fixture = Path(args.fixture)
    fixture = fixture if fixture.is_absolute() else ROOT / fixture
    result = measure(fixture, args.batch, args.seq, args.window, args.device)
    path = ROOT / RECORD
    if path.exists():
        blob = json.loads(path.read_text())
        blob["w4a8_tp2"] = {
            **{k: round(v, 5 if k.startswith("decode") else 4) if isinstance(v, float) else v
               for k, v in result.items()},
            "device": device_line(resolve_device(args.device)),
            "note": "teacher-forced decode-path ppl; tp2 = per-shard activation "
                    "quantization on row-parallel matvecs, two gloo ranks on one device",
        }
        path.write_text(json.dumps(blob, indent=1))
        print(f"recorded w4a8_tp2 in {path}")
    return result


if __name__ == "__main__":
    main()
