#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (metalchat_tpu_torch) on one
NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases (any failure makes the script exit non-zero without a result line):

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``metalchat_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build time.
3. Hold each kernel against its plain PyTorch version on the card, at the
   Llama-3.1-8B shapes of the main path and at the fixture's (hd=64):
   a8_matvec raw mode int32-exact; cache bytes exact; every other output
   elementwise within one bf16 rounding step of the plain version's (see
   ``RTOL``), the fused matvec with its norm prologue within 1e-2 abs; lengths
   at block edges, length 1, windows, and a zeroed cache whose output comes
   from the new row alone.
4. The trained fixture end to end, W4A8 + int8 KV, 3 requests through
   ``generate``: kernels on the card against the plain path on the CPU; the
   first 16 greedy tokens of each request must agree.
5. The main path at full width: ``8b-w4a8`` (Llama-3.1-8B geometry, all 32
   layers, random int4 weights from a seeded ``torch.Generator``, int8 KV,
   context 1024), a 512-token prompt then 64 greedy decode steps through
   ``generate``, with launch counts read around that run only; then
   ``torch.profiler`` over one prefill and 8 decode steps (the device's
   busy share and device time by kernel); then each kernel timed with CUDA
   events at the main path's shapes beside its bound, its plain version and
   one PyTorch library call as a yardstick.

The last lines are the kernel table as one JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

# Kernel vs plain version, elementwise: |got - ref| <= RTOL*|ref| + ATOL_OF_MAX*max|ref|.
# Both compute in f32 and differ only in summation order (and expf), so in
# bf16 they round to the same or a neighbouring value: one step is at most
# 2**-7 of the value. The limit scales with the data, so an error of one
# cache row in a long average (a missing new row, an edge off by one) fails.
RTOL = {"bfloat16": 2 ** -7, "float32": 1e-4}
ATOL_OF_MAX = 1e-4
# The fused matvec with its norm prologue: the f32 statistics may reduce in
# another order and move one int8 code by a quantum, a change far below 1e-2
# at these scales (the CPU tests hold the codes themselves).
MAX_ABS_ERR = 1e-2
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, 700 W


def hbm_rate(name: str) -> float:
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM rate recorded for {name!r}: add the card's "
                         "rate to HBM_BYTES_PER_S")
    return HBM_BYTES_PER_S[name]


def bound(nbytes: float, ops: float, op_type: str, rate: float):
    """Least time (ms) for the work, and whether bytes or operations set it."""
    t_bytes = nbytes / rate
    t_ops = ops / PEAK_OPS[op_type]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures = []
        self.err = {"a8_matvec": 0.0, "decode_attention_update": 0.0,
                    "flash_attention": 0.0}
        self.share = dict.fromkeys(self.err, 0.0)  # worst error / its limit

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
            return out
        except Exception:  # noqa: BLE001 — each phase reports and the run fails
            self.failures.append(name)
            print(f"[{name}] FAILED", flush=True)
            traceback.print_exc()
            return None

    def expect(self, cond: bool, what: str):
        if not cond:
            raise AssertionError(what)

    def close(self, kernel: str, got, want, what: str, loose: bool = False):
        dtype = str(got.dtype).removeprefix("torch.")
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        if loose:
            limit = self.torch.full_like(diff, MAX_ABS_ERR)
        else:
            limit = RTOL[dtype] * want.abs() + ATOL_OF_MAX * want.abs().max()
        err = diff.max().item()
        share = (diff / limit).max().item()
        self.err[kernel] = max(self.err[kernel], err)
        self.share[kernel] = max(self.share[kernel], share)
        self.expect(bool(self.torch.isfinite(got).all()), f"{what}: non-finite output")
        self.expect(share <= 1.0, f"{what}: {int((diff > limit).sum())} elements "
                    f"beyond the limit (max abs err {err}, {share:.3g} of the limit, "
                    f"max |ref| {want.abs().max().item():.4g})")

    def exact(self, got, want, what: str):
        self.expect(bool(self.torch.equal(got, want)), f"{what}: not bit-exact")

    # -- timing ---------------------------------------------------------------

    def device_ms(self, fn, iters: int) -> float:
        """Device time per call: `iters` calls captured in a CUDA graph and
        replayed between CUDA events, so host launch cost is excluded."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)

    def eager_ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn(0)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(line.splitlines()[0] if line else "nvidia-smi: no card listed", flush=True)
    return line


def phase_build():
    from metalchat_tpu_torch.ops import _build

    seconds = _build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(_build.KERNELS)} (parallel nvcc)")
    for name in _build.KERNELS:
        log = _build.build_log(name).splitlines()
        regs = [int(l.split("Used ")[1].split(" ")[0]) for l in log if "Used " in l]
        spills = [l.strip() for l in log if "spill" in l and " 0 bytes spill stores" not in l]
        print(f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers; spills: {spills or 'none'}")
    return seconds


# -- phase 3: kernels vs plain versions on the card ---------------------------

def check_a8(sm: Smoke, shapes, batch: int, gen, dev, dtype=None):
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import a8_matvec as m

    for name, out_f, in_f, bits, with_norm in shapes:
        k = in_f // 2 if bits == 4 else in_f
        p = torch.randint(-128, 128, (2, out_f, k), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand((2, 1, out_f), generator=gen, device=dev) * 0.0015
             + 0.0005).to(torch.bfloat16)
        nw = (torch.rand((2, in_f), generator=gen, device=dev) + 0.5).to(dtype)
        x = torch.randn((batch, in_f), generator=gen, device=dev).to(dtype)
        xq = torch.randint(-127, 128, (batch, in_f), generator=gen, device=dev,
                           dtype=torch.int8)
        what = f"a8_matvec {name} {out_f}x{in_f} w{bits} B={batch} {dtype}"
        sm.exact(m.quant_matvec_stacked(xq, p, 1, bits=bits),
                 m.quant_matvec_stacked_plain(xq, p, 1, bits=bits), what + " raw")
        sm.close("a8_matvec", m.quant_matvec_stacked_fused(x, p, s, 1, bits=bits),
                 m.quant_matvec_stacked_fused_plain(x, p, s, 1, bits=bits),
                 what + " fused")
        if with_norm:
            kw = dict(bits=bits, norm_stack=nw, norm_eps=1e-5)
            sm.close("a8_matvec", m.quant_matvec_stacked_fused(x, p, s, 1, **kw),
                     m.quant_matvec_stacked_fused_plain(x, p, s, 1, **kw),
                     what + " fused+norm", loose=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_decode(sm: Smoke, B, nh, nkv, T, hd, cases, gen, dev, dtype=None):
    """Each case is (lengths, window, cache): cache "random" holds random
    codes and scales, "zeros" holds zero codes and scales, so that the output
    is the new row's dequantized V times its softmax weight and a kernel that
    leaves the new row out returns 0."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import decode_attention as m

    for lengths, window, fill in cases:
        k = torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
        vs = torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
        if fill == "zeros":
            for t in (k, v, ks, vs):
                t.zero_()
        q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ref = m.decode_attention_update_plain(q, kn, vn, k.clone(), v.clone(), ks.clone(),
                                              vs.clone(), 1, lens, scale=hd ** -0.5,
                                              window=window)
        got = m.decode_attention_update_quantized_stacked(
            q, kn, vn, k, v, ks, vs, 1, lens, scale=hd ** -0.5, window=window)
        what = (f"decode_attention_update hd={hd} lengths={lengths} window={window} "
                f"{fill} cache {dtype}")
        sm.close("decode_attention_update", got[0], ref[0], what)
        for a, b, nm in zip(got[1:], ref[1:], ("k", "v", "k_scale", "v_scale")):
            sm.exact(a, b, f"{what} cache {nm}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_flash(sm: Smoke, B, S, nh, nkv, T, hd, cases, gen, dev, dtype=None):
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    for start, window in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, S, nh, hd), (B, nkv, T, hd), (B, nkv, T, hd)))
        sp = torch.tensor(start, dtype=torch.int32, device=dev) if isinstance(
            start, list) else start
        sm.close("flash_attention",
                 flash_attention(q, k, v, sp, scale=hd ** -0.5, window=window),
                 flash_attention_plain(q, k, v, sp, scale=hd ** -0.5, window=window),
                 f"flash_attention hd={hd} S={S} start={start} window={window} {dtype}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


# Lengths at block edges (64-position tiles), length 1, the main path's
# lengths (513-576), the full context, windows down to the new row alone,
# and zeroed caches.
DECODE_CASES_8B = [([1], None, "random"), ([64], None, "random"), ([65], None, "random"),
                   ([576], None, "random"), ([1024], None, "random"),
                   ([700], 100, "random"), ([576], 1, "random"), ([577], 2, "random"),
                   ([576], None, "zeros"), ([1024], None, "zeros")]
DECODE_CASES_FIXTURE = [([1, 64, 65], None, "random"), ([200, 17, 256], 50, "random"),
                        ([2, 64, 130], None, "zeros"), ([65, 128, 256], 1, "random")]
# Flash: (start_pos, window); a list is one start per batch row.
FLASH_CASES_FIXTURE = [(0, None), ([0, 17, 64], None), (0, 20), ([63, 1, 0], 1)]


def phase_kernels(sm: Smoke):
    torch = sm.torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    h, f, v = 4096, 14336, 128256
    check_a8(sm, [("wqkv", 6144, h, 4, True), ("wo", h, h, 4, False),
                  ("w13", 2 * f, h, 4, True), ("w2", h, f, 4, False),
                  ("lm_head", v, h, 4, False), ("wo", h, h, 8, False)], 1, gen, dev)
    check_a8(sm, [("wqkv", 768, 384, 4, True), ("wo", 384, 384, 4, False),
                  ("w13", 2048, 384, 4, True), ("w2", 384, 1024, 4, False),
                  ("lm_head", 384, 384, 8, False)], 3, gen, dev)
    check_decode(sm, 1, 32, 8, 1024, 128, DECODE_CASES_8B, gen, dev)
    check_decode(sm, 3, 6, 3, 256, 64, DECODE_CASES_FIXTURE, gen, dev)
    check_flash(sm, 1, 512, 32, 8, 1024, 128, [(0, None), (100, None), (0, 128), (64, 1)],
                gen, dev)
    check_flash(sm, 3, 48, 6, 3, 256, 64, FLASH_CASES_FIXTURE, gen, dev)
    print("max |kernel - plain| in bf16 (raw int32 and cache bytes exact): "
          + ", ".join(f"{k} {v:.3g} ({sm.share[k]:.3g} of its limit)"
                      for k, v in sm.err.items()))


# -- phase 4: the fixture end to end ---------------------------------------------

def phase_fixture(sm: Smoke):
    torch = sm.torch
    from pathlib import Path

    import numpy as np

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import quantize_params

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    prompts = torch.from_numpy(
        np.load(fixture / "eval_tokens.npy")[:3 * 48].astype(np.int64).reshape(3, 48))
    outs = {}
    for device in ("cuda", "cpu"):
        params = load_params(open_safetensors(fixture), cfg, dtype=torch.bfloat16,
                             max_seq_len=256, device=device)
        params = fuse_projections(
            quantize_params(params, bits=4, group_size=None, act_bits=8), cfg)
        reset_launch_counts()
        outs[device] = generate(params, cfg, prompts, max_new_tokens=64,
                                quantized_kv=True).cpu()
        if device == "cuda":
            counts = launch_counts()
    agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
    first16 = bool(torch.equal(outs["cuda"][:, :16], outs["cpu"][:, :16]))
    print(f"fixture w4a8+int8kv, 3 requests x 64 tokens: card vs CPU plain "
          f"agreement {agree:.4f}, first 16 identical: {first16}, launches {counts}")
    sm.expect(first16, "fixture: first 16 greedy tokens differ between card and CPU")
    sm.expect(all(n > 0 for n in counts.values()), f"fixture: a kernel never ran {counts}")


# -- phase 5: 8b-w4a8 at full width --------------------------------------------

def weight_bytes(params) -> int:
    """bench.py's accounting: every weight except the embedding table (one
    row is gathered) and the rope tables."""
    from metalchat_tpu_torch.quant.quantize import QuantizedTensor

    def nbytes(node):
        if isinstance(node, QuantizedTensor):
            return nbytes(node.q) + nbytes(node.scales)
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        return node.numel() * node.element_size()

    return nbytes(params) - nbytes(params["rope"]) - nbytes(params["embed"])


def phase_main(sm: Smoke, dev_name: str):
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    dev = torch.device("cuda")
    ctx, prompt_len, new = 1024, 512, 64
    cfg = LlamaConfig.llama31_8b(max_seq_len=ctx)
    t0 = time.perf_counter()
    params = fuse_projections(init_random_quantized_params(
        cfg, bits=4, group_size=None, act_bits=8, max_seq_len=ctx, seed=0,
        device=dev), cfg)
    torch.cuda.synchronize()
    print(f"8b-w4a8 params: {weight_bytes(params) / 1e9:.3f} GB of weights, "
          f"made in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev)

    def run(n_new):
        cache = QuantizedKVCache.create(cfg, 1, ctx, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out, cache

    run(2)  # warm-up: libraries, cuBLAS handles, first launches
    reset_launch_counts()
    ttft, _, _ = run(1)
    total, out, cache = run(new + 1)
    counts = launch_counts()
    decode_s = total - ttft
    tok_s = new / decode_s
    kv_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * (ctx / 2) * (cfg.head_dim + 4)
    bpt = weight_bytes(params) + cfg.hidden_size * 2 + kv_bytes
    rate = hbm_rate(dev_name)
    sm.expect(out.shape == (1, new + 1) and bool((out >= 0).all())
              and bool((out < cfg.vocab_size).all()), f"8b: bad tokens {out.shape}")
    per_step = {"a8_matvec": 4 * cfg.num_layers + 1,
                "decode_attention_update": cfg.num_layers}
    want = {"a8_matvec": per_step["a8_matvec"] * new,
            "decode_attention_update": per_step["decode_attention_update"] * new,
            "flash_attention": 2 * cfg.num_layers}
    print(f"8b-w4a8 main path: decode {tok_s:.2f} tok/s, TTFT {1e3 * ttft:.2f} ms "
          f"(prompt {prompt_len}), {bpt / 1e9:.4f} GB/token, "
          f"{tok_s * bpt / rate:.4f} of {rate / 1e12:.2f} TB/s HBM, launches {counts}")
    sm.expect(all(counts[k] > 0 for k in counts), f"8b: a kernel never ran {counts}")
    sm.expect(counts["a8_matvec"] == want["a8_matvec"]
              and counts["decode_attention_update"] == want["decode_attention_update"]
              and counts["flash_attention"] == want["flash_attention"],
              f"8b: launches {counts} != expected {want}")
    return cfg, params, cache, counts, prompt_len + new, prompt


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(sm: Smoke, main):
    """Where the main path's time goes: torch.profiler over one 512-token
    prefill and 8 decode steps of the 8B model, the device's busy share of
    the host's wall time and device time by kernel."""
    torch = sm.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    cfg, params, _, _, _, prompt = main
    dev = torch.device("cuda")
    cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
    s = prompt.shape[1]
    steps = {"prefill": lambda: forward(params, cache, prompt, 0, cfg),
             "decode x8": lambda: [forward(params, cache, prompt[:, i:i + 1], s + i, cfg)
                                   for i in range(8)]}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            print(f"  profile {name}: device busy share not measured "
                  "(the profiler recorded no device activity)")
            continue
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        by_name = {}
        for e in kernels:
            key = next((k for k in ("a8_matvec", "decode_update", "flash") if k in e.name),
                       e.name[:48])
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  profile {name}: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({busy / wall_us:.4f} of wall), {len(kernels)} "
              "kernels; device ms by kernel: "
              + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top))


def phase_timing(sm: Smoke, main, rate: float):
    """Each kernel at the main path's shapes: kernel (CUDA graph replay),
    plain version (eager), one library call (graph), and the bound."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from metalchat_tpu_torch.quant.quantize import _unpack_int4

    cfg, params, cache, counts, length, _ = main
    dev = torch.device("cuda")
    L, h = cfg.num_layers, cfg.hidden_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    layers = params["layers"]
    rows = []

    # a8_matvec: one decode step's calls (4 per layer + lm_head).
    x = torch.randn((1, h), generator=gen, device=dev).to(torch.bfloat16)
    x2 = torch.randn((1, cfg.intermediate_size), generator=gen, device=dev).to(torch.bfloat16)
    lm = params["lm_head"]
    a8 = [("wqkv", layers["wqkv"].q, layers["wqkv"].scales, x, layers["attn_norm"], L),
          ("wo", layers["wo"].q, layers["wo"].scales, x, None, L),
          ("w13", layers["w13"].q, layers["w13"].scales, x, layers["ffn_norm"], L),
          ("w2", layers["w2"].q, layers["w2"].scales, x2, None, L),
          ("lm_head", lm.q[None], lm.scales[None], x, None, 1)]
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    raw_step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for name, pq, ps, xin, norm, per_step in a8:
        n_layers, out_f, k = pq.shape
        in_f = 2 * k
        kw = dict(bits=4) if norm is None else dict(
            bits=4, norm_stack=norm, norm_eps=cfg.rms_norm_eps)
        ms = sm.device_ms(lambda i: am.quant_matvec_stacked_fused(
            xin, pq, ps, i % n_layers, **kw), 64)
        plain = sm.eager_ms(lambda i: am.quant_matvec_stacked_fused_plain(
            xin, pq, ps, i % n_layers, **kw), 3)
        # Library yardstick: cuBLAS int8 GEMM on the unpacked int8 weights at
        # its smallest row count (17); enough layers to exceed the L2 cache.
        n_lib = max(1, min(n_layers, math.ceil(120e6 / (out_f * in_f))))
        unpacked = [_unpack_int4(pq[i], -1).contiguous() for i in range(n_lib)]
        xq17 = torch.randint(-127, 128, (17, in_f), generator=gen, device=dev,
                             dtype=torch.int8)
        lib = sm.device_ms(lambda i: torch._int_mm(xq17, unpacked[i % n_lib].t()), 32)
        del unpacked
        # Raw mode (int8 rows in, int32 out) at the same shapes.
        xq1 = xq17[:1]
        raw_ms = sm.device_ms(lambda i: am.quant_matvec_stacked(
            xq1, pq, i % n_layers, bits=4), 64)
        raw_plain = sm.eager_ms(lambda i: am.quant_matvec_stacked_plain(
            xq1, pq, i % n_layers, bits=4), 3)
        raw_bound, _ = bound(out_f * k + in_f + out_f * 4, 2 * in_f * out_f, "int8", rate)
        for key, val in (("ms", raw_ms), ("plain_ms", raw_plain), ("bound_ms", raw_bound)):
            raw_step[key] += per_step * val
        nbytes = out_f * k + out_f * 2 + in_f * 2 + out_f * 2 + (in_f * 2 if norm is not None else 0)
        b_ms, b_by = bound(nbytes, 2 * in_f * out_f, "int8", rate)
        print(f"  a8_matvec {name} [{out_f}x{in_f} w4]: {ms * 1e3:.2f} us "
              f"(bound {b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; "
              f"_int_mm M=17 int8 {lib * 1e3:.2f} us) x{per_step}/token")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b_ms)):
            step[key] += per_step * val
    print(f"  a8_matvec raw mode (not on the main path), one decode step's {4 * L + 1} "
          f"shapes: {raw_step['ms']:.4f} ms (bound {raw_step['bound_ms']:.4f} ms, bytes; "
          f"plain {raw_step['plain_ms']:.3f} ms)")
    rows.append(dict(name="a8_matvec", source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                     replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262",
                     bound_by="bytes", unit=f"one decode step ({4 * L + 1} calls)",
                     **step))

    # decode_attention_update: one decode step (one call per layer) at the
    # main path's last length.
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    ms = sm.device_ms(lambda i: dm.decode_attention_update_quantized_stacked(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 64)
    plain = sm.eager_ms(lambda i: dm.decode_attention_update_plain(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 5)
    kd = dequantize_kv(cache.k[0, :, :, :length], cache.k_scale[0, :, :, :length])
    vd = dequantize_kv(cache.v[0, :, :, :length], cache.v_scale[0, :, :, :length])
    # Library yardstick: SDPA over the dequantized bf16 K/V of one layer, its
    # KV heads repeated to the query heads outside the timed call.
    q4 = q[:, :, None, :]
    kd, vd = (t.repeat_interleave(nh // nkv, dim=1) for t in (kd, vd))
    lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(q4, kd, vd), 64)
    nbytes = (2 * nkv * length * (hd + 4) + 2 * nh * hd * 2 + 2 * nkv * hd * 2
              + 2 * nkv * (hd + 4))
    b_ms, b_by = bound(nbytes, 4 * nh * hd * length, "f32", rate)
    print(f"  decode_attention_update [length {length}, T {cache.k.shape[3]}]: "
          f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}; plain "
          f"{plain * 1e3:.1f} us; sdpa bf16 {lib * 1e3:.2f} us) x{L}/token")
    rows.append(dict(name="decode_attention_update",
                     source="metalchat_tpu_torch/csrc/decode_attention.cu",
                     replaces="metalchat_tpu/ops/decode_attention_pallas.py:598",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one decode step ({L} calls, length {length})"))

    # flash_attention: one 512-token prefill (one call per layer).
    S = 512
    qf = torch.randn((1, S, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kf = dequantize_kv(cache.k[0, :, :, :S], cache.k_scale[0, :, :, :S])
    vf = dequantize_kv(cache.v[0, :, :, :S], cache.v_scale[0, :, :, :S])
    ms = sm.device_ms(lambda i: flash_attention(qf, kf, vf, 0, scale=hd ** -0.5), 8)
    plain = sm.eager_ms(lambda i: flash_attention_plain(qf, kf, vf, 0,
                                                           scale=hd ** -0.5), 3)
    qt = qf.transpose(1, 2)
    kr, vr = (t.repeat_interleave(nh // nkv, dim=1) for t in (kf, vf))
    lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(
        qt, kr, vr, is_causal=True), 8)
    nbytes = 2 * (2 * S * nh * hd + 2 * nkv * S * hd)
    b_ms, b_by = bound(nbytes, 4 * hd * nh * S * (S + 1) / 2, "bf16", rate)
    print(f"  flash_attention [S {S}, kv {S}]: {ms * 1e3:.1f} us (bound "
          f"{b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; sdpa causal "
          f"{lib * 1e3:.1f} us) x{L}/prefill")
    rows.append(dict(name="flash_attention",
                     source="metalchat_tpu_torch/csrc/flash_attention.cu",
                     replaces="metalchat_tpu/ops/flash_attention_pallas.py:136",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one {S}-token prefill ({L} calls)"))
    for r in rows:
        r.update(route="cuda", launches=counts[r["name"]],
                 max_abs_err=sm.err[r["name"]])
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import metalchat_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (metalchat_tpu_torch "
              "not importable)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    sm = Smoke(torch)
    t_start = time.perf_counter()
    smi = sm.phase("device", phase_device)
    dev_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {dev_name}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    if sm.phase("build", phase_build) is not None:
        sm.phase("kernels", lambda: phase_kernels(sm))
        sm.phase("fixture", lambda: phase_fixture(sm))
        main_run = sm.phase("main", lambda: phase_main(sm, dev_name))
        rows = None
        if main_run is not None:
            sm.phase("profile", lambda: phase_profile(sm, main_run))
            rows = sm.phase("timing", lambda: phase_timing(sm, main_run, hbm_rate(dev_name)))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if sm.failures or not smi:
        print(f"chip_smoke: FAILED phases: {sm.failures}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "unit")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
