#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (metalchat_tpu_torch) on one
NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases (any failure makes the script exit non-zero without a result line):

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``metalchat_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once) and print the build time, registers and
   spills (each instance of the redesigned kernels on a line).
3. Hold each kernel against its plain PyTorch version on the card, at the
   Llama-3.1-8B shapes of the main path and at the fixture's (hd=64):
   a8_matvec raw mode int32-exact; cache bytes exact; every other output
   elementwise within one bf16 rounding step of the plain version's (see
   ``RTOL``), the fused matvec with its norm prologue within 1e-2 abs; lengths
   at block edges, length 1, windows, and a zeroed cache whose output comes
   from the new row alone. The matvec at 1, 2, 3, 5, 8 and 16 rows of the
   8B widths (int8 at 1 and 8), with a8_quantize (2-16 rows) held to the
   plain prologue's codes. The serve path's shapes too: decode attention
   (write and read-only, bf16 and
   int8 caches) at 8 rows of per-row lengths up to 1024, flash over
   256-token chunks of 8 rows at per-row offsets. Decode lengths at the
   edges of the kernel's 32-position chunks (``SPLIT_CHUNK``), windows
   starting inside a chunk, a batch that leaves most chunks dead; flash over
   a ragged 137-token chunk from unaligned starts; each attention wrapper
   the matvec at 2 rows (fused: two launches; raw), the paged kernel in both
   modes and the dequant matmul (split-K at 1 and 8 rows, tensor cores)
   called twice inside one CUDA graph, replayed twice: outputs equal bit for bit across replays
   (the decode merge's order is fixed and its arrival counters reset) and
   within the limit of the plain version (raw exact).
   The paged kernel (both modes) at the 8B serving shape (8 rows, pages of
   256, 4 pages a row, 32 + 1 pages) and the fixture's (pages of 16), page
   tables shuffled with one free row at the sentinel: outputs of the rows
   whose write page is live within ``RTOL``, pages and scales exact except
   the shared garbage page; also pages of 8 and 48 at the 8B widths and of
   4 at the fixture's, where the kernel's chunks of 32 positions cross
   pages, lengths at the chunk edges. The dequant matmul (row 11) at the 8b-int4 and
   1b-int8 shapes, 1, 8 and 32 rows, within ``RTOL``; the merged FFN block
   (row 10) at 8B widths, 1 and 8 rows, phase by phase (see ``ACT_SLOPE``).
4. The trained fixture end to end, W4A8 + int8 KV, 3 requests through
   ``generate``: kernels on the card against the plain path on the CPU; the
   first 16 greedy tokens of each request must agree. fixture-int: the same
   for the fixture quantized weight-only (int4 and int8, group 32) and for
   W4A8 with ``ffn_block=True``, in bf16, and each decode step's logits fed
   the CPU's tokens within ``check_logits``'s limit. After every phase the
   split kernels' arrival counters must be back at zero.
5. The main path at full width: ``8b-w4a8`` (Llama-3.1-8B geometry, all 32
   layers, random int4 weights from a seeded ``torch.Generator``, int8 KV,
   context 1024), a 512-token prompt then 64 greedy decode steps through
   ``generate``, every kernel's launches held exactly around that run; then
   ``torch.profiler`` over one prefill and 8 decode steps (the device's
   busy share and device time by kernel). main-ffn-block: the same params
   with ``ffn_block=True`` (32 ffn_block and 33 a8_matvec launches a step),
   then both routes in turns. main-int4: ``8b-int4`` (weight-only int4,
   group 32), 129 dequant-matmul launches a step, and its profile.
6. serve-fixture: the fixture through ``ContinuousBatchingEngine`` (6 greedy
   requests, 3 slots, chunks of 32, bursts of 4, f32 activations) in paged
   (pages of 16), dense int8 and dense activation-dtype mode, on the card
   and on the CPU plain path: the first 16 tokens of each request agree
   card vs CPU, and paged vs dense int8 on the card.
7. serve: ``8b-w4a8`` behind ``ContinuousBatchingEngine`` with the workload
   of ``bench.py --mode serve`` (24 requests at once, prompts of 48-640
   tokens, 96 greedy tokens each, 8 slots, bursts of 32, chunks of 256),
   paged (pages of 256) then dense int8, each after a 2-request warm-up:
   tok/s, TTFT and service TTFT p50/p99, the share of the full-slot decode
   roofline, and launch counts held exactly to the engine's counters and
   prompt-chunk shapes (a8_quantize once per matvec call of 2-16 rows, 0 in
   the batch-1 generate phases); then ``torch.profiler``
   over one paged decode dispatch (8 steps) with all 8 slots decoding.
8. http: the fixture behind ``InferenceServer`` on 127.0.0.1 (paged, on the
   card): a blocking completion, its SSE stream (same text), a chat
   completion, ``/health`` and ``/metrics``.
9. Each kernel timed with CUDA events at its path's shapes beside its bound,
   its plain version and one PyTorch library call as a yardstick: timing at
   the generate path's shapes (and row 3 at lengths 64 and 1024, row 4 at
   hd=64, kernel and yardstick only), timing-serve at the serve path's (8 rows;
   rows 1-2 per matrix with a8_quantize alone, and their step at 2 and 16
   rows), timing-ffn (row 10 beside the unmerged route) and timing-int4 (row 11
   at 1 and 8 rows, per matrix).

The last lines are the kernel table as one JSON object (rows 1-11 of the
JAX package's TPU kernels), the card's name and power limit, and
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
# The merged FFN block (row 10) is held phase by phase through its own
# scratch (x2, h), so that every phase reads the kernel's own input. Phases A
# (x2 = x + wo(attn)) and C (out = x2 + w2(h)) then compute the plain
# version's int8 codes exactly and meet the one-step limit above. In phase B
# the kernel's f32 norm statistics (block order, 1/sqrtf) and expf may differ
# from the plain version's by an ulp, which can move one int8 code of the
# normed x2 by a quantum at a rounding boundary. That shifts gate[j] by at
# most sx_n * s_gate[j] * QMAX (up likewise), so h[j] moves by at most
# ACT_SLOPE*|up|*dg + |act(gate)|*du + ACT_SLOPE*dg*du: phase B's limit adds
# that to the one-step limit. A code of h that moves in phase B moves in both
# versions of phase C alike, since phase C starts from the kernel's h.
ACT_SLOPE = 1.13  # sup |act'|: silu 1.0998, gelu_tanh 1.1289
QMAX = {4: 8, 8: 127}  # largest |weight code|: int4 nibble, int8
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # H100 SXM
# The kernels `generate` runs with an int8 dense cache.
GENERATE_KERNELS = ("a8_matvec", "decode_attention_update", "flash_attention")
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
        self.err = {"a8_matvec": 0.0, "a8_quantize": 0.0, "decode_attention_update": 0.0,
                    "decode_attention": 0.0, "flash_attention": 0.0,
                    "paged_decode_attention_update": 0.0, "paged_decode_attention": 0.0,
                    "quant_matmul": 0.0, "ffn_block": 0.0}
        self.share = dict.fromkeys(self.err, 0.0)  # worst error / its limit
        self.tok_s = {}  # decode tok/s by run
        self.a8_library = {}  # torch._int_mm at M=17 per matvec shape (phase timing)

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            self.counters_at_rest(name)
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

    def close(self, kernel: str, got, want, what: str, loose: bool = False, extra=None):
        """Elementwise within the limit; ``extra`` (a tensor of the output's
        shape) widens it where a stated cause may move a value further."""
        dtype = str(got.dtype).removeprefix("torch.")
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        if loose:
            limit = self.torch.full_like(diff, MAX_ABS_ERR)
        else:
            limit = RTOL[dtype] * want.abs() + ATOL_OF_MAX * want.abs().max()
        if extra is not None:
            limit = limit + extra
        err = diff.max().item()
        share = (diff / limit).max().item()
        self.err[kernel] = max(self.err[kernel], err)
        self.share[kernel] = max(self.share[kernel], share)
        self.expect(bool(self.torch.isfinite(got).all()), f"{what}: non-finite output")
        self.expect(share <= 1.0, f"{what}: {int((diff > limit).sum())} elements "
                    f"beyond the limit (max abs err {err}, {share:.3g} of the limit, "
                    f"max |ref| {want.abs().max().item():.4g})")

    def counters_at_rest(self, what: str):
        """Every launch of a split kernel leaves the arrival counters it used
        at zero (``ops/_build.arrival_counters``); a count left behind would
        merge a later launch's partials early."""
        build = sys.modules.get("metalchat_tpu_torch.ops._build")
        for dev, buf in ({} if build is None else build._COUNTERS).items():
            n = int((buf != 0).sum())
            self.expect(n == 0, f"{what}: {n} arrival counters on {dev} not at zero")

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
    # The redesigned kernels' instances, one line each.
    for name in ("a8_matvec", "flash_attention", "decode_attention", "quant_matmul",
                 "paged_attention"):
        for fn, regs, spill in entry_functions(_build.build_log(name)):
            if name != "a8_matvec" or "a8_matvec_kernel" not in fn:
                print(f"    {name} {fn}: {regs} registers, spill stores/loads {spill} bytes")
    return seconds


def entry_functions(log: str):
    """(demangled name, registers, "stores/loads") of each entry function in
    an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line and fn:
            words = line.replace(",", "").split()
            spill = f"{words[words.index('spill') - 2]}/{words[words.index('loads') - 3]}"
        elif "Used " in line and fn:
            out.append((fn, int(line.split("Used ")[1].split(" ")[0]), spill))
            fn, spill = None, "?"
    try:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _, _ in out),
                               capture_output=True, text=True, timeout=30).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) >= len(out):
        out = [(n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0],
                r, sp) for n, (_, r, sp) in zip(names, out)]
    return out


# -- phase 3: kernels vs plain versions on the card ---------------------------

def check_quantize(sm: Smoke, x, nw, what: str):
    """a8_quantize (2-16 rows) against the plain prologue: without the norm
    the codes, sx and corr are exact (same op order); with it the f32
    statistics may reduce in another order and move a code by one quantum
    at a rounding boundary (and the largest value by one step of x's dtype),
    so codes within 1, sx within ``RTOL`` of x's dtype, and corr exact against
    the kernel's own codes."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import a8_matvec as m

    kw = dict(norm_w=nw, norm_eps=None if nw is None else 1e-5)
    xq, sx, corr = m.quantize_rows(x, **kw)
    want_q, want_s, want_c = m.quantize_rows_plain(x, **kw)
    moved = (xq.int() - want_q.int()).abs().max().item()
    sm.err["a8_quantize"] = max(sm.err["a8_quantize"], moved)
    sm.share["a8_quantize"] = max(sm.share["a8_quantize"], moved)
    if nw is None:
        sm.exact(xq, want_q, what + " codes")
        sm.exact(sx, want_s, what + " sx")
        sm.exact(corr, want_c, what + " corr")
        return
    sm.expect(moved <= 1, f"{what}: a code moved by {moved} quanta")
    rtol = RTOL[str(x.dtype).removeprefix("torch.")]
    sm.expect(bool(((sx - want_s).abs() <= rtol * want_s.abs()).all()), f"{what}: sx")
    sm.exact(corr, 8 * xq[:, :x.shape[1] // 2].sum(dim=1, dtype=torch.int32), what + " corr")


def check_a8(sm: Smoke, shapes, batch: int, gen, dev, dtype=None):
    """Raw mode int32-exact, fused within RTOL of the plain version (1e-2
    abs with the norm prologue); at 2-16 rows a8_quantize on its own too."""
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
        if batch > 1:
            check_quantize(sm, x, nw[1] if with_norm else None, what + " a8_quantize")
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


def check_decode_read(sm: Smoke, B, nh, nkv, T, hd, cases, gen, dev, dtype=None,
                      kv="act"):
    """The read-only mode over layer 1 of a 2-layer dense cache: in the
    activation dtype (``kv="act"``, random values) or int8 with scales.
    Each case is (lengths, window)."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import decode_attention as m

    for lengths, window in cases:
        if kv == "act":
            k, v = (torch.randn((2, B, nkv, T, hd), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            ks = vs = None
        else:
            k, v = (torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01
                      for _ in range(2))
        q = torch.randn((B, nh, hd), generator=gen, device=dev).to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(scale=hd ** -0.5, window=window)
        if kv == "act":
            got = m.decode_attention_stacked(q, k, v, 1, lens, **kw)
        else:
            got = m.decode_attention_quantized_stacked(q, k, v, ks, vs, 1, lens, **kw)
        sm.close("decode_attention", got,
                 m.decode_attention_stacked_plain(q, k, v, ks, vs, 1, lens, **kw),
                 f"decode_attention hd={hd} {kv} cache lengths={lengths} window={window} "
                 f"{dtype}")
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


def check_graph_replay(sm: Smoke, B, nh, nkv, T, hd, gen, dev, dtype=None):
    """Two calls of each attention wrapper captured in one CUDA graph, the
    graph replayed twice. The second call can merge only if the first left
    the decode kernel's arrival counters at 0; its output must be equal bit
    for bit across the two replays (the merge order is fixed) and within
    the limit of the plain version. Rows at very different lengths, one in
    a window that starts inside a chunk; the paged kernel in both modes over
    pages of 16, its pool exact after the replays. The same for the matvec at B rows
    (wqkv's shape, int4): the fused route's two launches (a8_quantize, then
    the tensor-core matvec, whose inputs the wrapper allocates on every
    call) with the norm prologue, and raw mode, exact; and the dequant
    matmul (row 11): the split-K natural route at 1 and 8 rows, whose
    last block merges the workspace, and the transposed route at B rows."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm
    from metalchat_tpu_torch.ops import quant_matmul as qm
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    lengths = [T - 1 - 17 * b for b in range(B)]
    lengths[-1] = SPLIT_CHUNK + 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    window = 3 * SPLIT_CHUNK + 5
    k, v = (torch.randint(-127, 128, (2, B, nkv, T, hd), generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((2, B, nkv, T), generator=gen, device=dev) * 0.01 for _ in range(2))
    kc, vc = (torch.randn((2, B, nkv, T, hd), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
    S = min(256, T // 2)
    qf, kf, vf = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, S, nh, hd), (B, nkv, T, hd), (B, nkv, T, hd)))
    starts = torch.tensor([T - S - 3 * b for b in range(B)], dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5)
    ref_cache = [t.clone() for t in (k, v, ks, vs)]
    in_f, out_f = nh * hd, (nh + 2 * nkv) * hd
    pw = torch.randint(-128, 128, (2, out_f, in_f // 2), generator=gen, device=dev,
                       dtype=torch.int8)
    sw = (torch.rand((2, 1, out_f), generator=gen, device=dev) * 0.0015 + 0.0005).to(
        torch.bfloat16)
    nw = (torch.rand((2, in_f), generator=gen, device=dev) + 0.5).to(dtype)
    xa = torch.randn((B, in_f), generator=gen, device=dev).to(dtype)
    xq = torch.randint(-127, 128, (B, in_f), generator=gen, device=dev, dtype=torch.int8)
    a8 = dict(bits=4, norm_stack=nw, norm_eps=1e-5)
    # Row 11: the non-transposed split-K route at 1 and 8 rows (wo's shape:
    # partials through the workspace, the last block of a strip merging
    # them) and the transposed tensor-core route, int4, group 32.
    qk = dict(bits=4, group_size=32)
    qn = torch.randint(-128, 128, (in_f // 2, in_f), generator=gen, device=dev,
                       dtype=torch.int8)
    sn = (torch.rand((in_f // 32, in_f), generator=gen, device=dev) * 0.01 + 0.001).to(
        torch.bfloat16)
    qt = torch.randint(-128, 128, (out_f, in_f // 2), generator=gen, device=dev,
                       dtype=torch.int8)
    st = (torch.rand((out_f, in_f // 32), generator=gen, device=dev) * 0.01 + 0.001).to(
        torch.bfloat16)
    xr = {r: torch.randn((r, in_f), generator=gen, device=dev).to(dtype) for r in (1, 8)}
    # Rows 8-9: the paged kernel over pages of 16 (chunks cross pages), the
    # same lengths and window; the pool is updated in place, and the second
    # call of a replay writes the same bytes as the first.
    psize, mp = 16, T // 16
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)
    pool = [torch.randint(-127, 128, (2, nkv, B * mp + 1, psize, hd), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2)]
    pool += [torch.rand((2, B * mp + 1, nkv, psize), generator=gen, device=dev) * 0.01
             for _ in range(2)]
    ref_pool = [t.clone() for t in pool]
    cases = {  # name: (call, plain output, comparison)
        "decode_attention_update": (
            lambda: dm.decode_attention_update_quantized_stacked(
                q, kn, vn, k, v, ks, vs, 1, lens, window=window, **kw)[0],
            dm.decode_attention_update_plain(q, kn, vn, *ref_cache, 1, lens, window=window,
                                             **kw)[0], "close"),
        "decode_attention": (
            lambda: dm.decode_attention_stacked(q, kc, vc, 1, lens, **kw),
            dm.decode_attention_stacked_plain(q, kc, vc, None, None, 1, lens, **kw), "close"),
        "flash_attention": (
            lambda: flash_attention(qf, kf, vf, starts, **kw),
            flash_attention_plain(qf, kf, vf, starts, **kw), "close"),
        "a8_matvec": (
            lambda: am.quant_matvec_stacked_fused(xa, pw, sw, 1, **a8),
            am.quant_matvec_stacked_fused_plain(xa, pw, sw, 1, **a8), "loose"),
        "a8_matvec_raw": (
            lambda: am.quant_matvec_stacked(xq, pw, 1, bits=4),
            am.quant_matvec_stacked_plain(xq, pw, 1, bits=4), "exact"),
        "quant_matmul natural 1 row": (
            lambda: qm.dequant_matmul(xr[1], qn, sn, transposed=False, **qk),
            qm.dequant_matmul_plain(xr[1], qn, sn, transposed=False, **qk), "close"),
        "quant_matmul natural 8 rows": (
            lambda: qm.dequant_matmul(xr[8], qn, sn, transposed=False, **qk),
            qm.dequant_matmul_plain(xr[8], qn, sn, transposed=False, **qk), "close"),
        "quant_matmul transposed": (
            lambda: qm.dequant_matmul(xa, qt, st, transposed=True, **qk),
            qm.dequant_matmul_plain(xa, qt, st, transposed=True, **qk), "close"),
        "paged_decode_attention_update": (
            lambda: pm.paged_decode_attention_update_stacked(
                q, kn, vn, *pool, table, lens, 1, window=window, **kw)[0],
            pm.paged_decode_attention_update_plain(
                q, kn, vn, *ref_pool, table, lens, 1, window=window, **kw)[0], "close"),
        "paged_decode_attention": (
            lambda: pm.paged_decode_attention_stacked(q, *pool, table, lens, 0, **kw),
            pm.paged_decode_attention_plain(q, *ref_pool, table, lens, 0, **kw), "close"),
    }
    for name, (kernel, want, compare) in cases.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            kernel()
            out = kernel()
        replays = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(out.clone())
        what = f"{name} lengths={lengths} B={B} second call in a CUDA graph"
        sm.exact(replays[0], replays[1], f"{what}: two replays")
        if compare == "exact":
            sm.exact(replays[1], want, what)
        else:
            sm.close(name.split(" ")[0], replays[1], want, what, loose=compare == "loose")
    for a, b, nm in zip((k, v, ks, vs), ref_cache, ("k", "v", "k_scale", "v_scale")):
        sm.exact(a, b, f"decode_attention_update in a CUDA graph: cache {nm}")
    for a, b, nm in zip(pool, ref_pool, ("k", "v", "k_scale", "v_scale")):
        sm.exact(a, b, f"paged_decode_attention_update in a CUDA graph: pool {nm}")


def paged_table(torch, B, mp, psize, n_pages, lengths, gen, dev):
    """A page table as the engine builds it: each live row owns the pages
    its length needs, drawn from a shuffled pool so that they are not
    contiguous; the rest, and the whole last (free) row, at the sentinel."""
    order = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, mp), n_pages, dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths[:-1]):
        need = -(-n // psize)
        table[b, :need] = order[b * mp:b * mp + need]
    return table


def check_paged(sm: Smoke, B, nh, nkv, hd, psize, mp, cases, gen, dev, dtype=None):
    """Both modes of the paged kernel against the plain version, on layer 1
    of a 2-layer pool of B·mp + 1 pages. Each case is (lengths, window); the
    last row is a free row at the sentinel with length 1. Outputs are held
    on the rows whose write page is live (rows that write the shared garbage
    page race there and get an undefined output), pages and scales exactly
    on every page but the garbage page."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import paged_attention as m

    n_pages = B * mp
    for lengths, window in cases:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        table = paged_table(torch, B, mp, psize, n_pages, lengths, gen, dev)
        pages = [torch.randint(-127, 128, (2, nkv, n_pages + 1, psize, hd), generator=gen,
                               device=dev, dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((2, n_pages + 1, nkv, psize), generator=gen, device=dev) * 0.01
                  for _ in range(2)]
        q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, nh, hd), (B, nkv, hd), (B, nkv, hd)))
        what = (f"paged hd={hd} psize={psize} mp={mp} lengths={lengths} window={window} "
                f"{dtype}")
        live = table[torch.arange(B, device=dev), (lens.long() - 1) // psize] != n_pages
        cache = [t.clone() for t in pages + scales]
        ref = m.paged_decode_attention_update_plain(
            q, kn, vn, *cache, table, lens, 1, scale=hd ** -0.5, window=window)
        got = m.paged_decode_attention_update_stacked(
            q, kn, vn, *pages, *scales, table, lens, 1, scale=hd ** -0.5, window=window)
        sm.close("paged_decode_attention_update", got[0][live], ref[0][live],
                 f"{what} update")
        for a, b, nm in zip(got[1:], ref[1:], ("k", "v", "k_scale", "v_scale")):
            live_pages = (slice(None), slice(None), slice(0, n_pages)) if a.ndim == 5 else (
                slice(None), slice(0, n_pages))
            sm.exact(a[live_pages], b[live_pages], f"{what} update {nm}")
        sm.close("paged_decode_attention",
                 m.paged_decode_attention_stacked(q, *pages, *scales, table, lens, 0,
                                                  scale=hd ** -0.5, window=window),
                 m.paged_decode_attention_plain(q, *pages, *scales, table, lens, 0,
                                                scale=hd ** -0.5, window=window),
                 f"{what} read-only")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def check_qmm(sm: Smoke, shapes, rows: int, gen, dev, dtype=None, scales_dtype=None):
    """The dequant-matmul kernel (row 11) against its plain version. Each
    shape is (name, out, in, bits, group, transposed); random packed bytes,
    positive scales in ``scales_dtype`` (bf16 by default), x in ``dtype``."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    scales_dtype = scales_dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import quant_matmul as m

    for name, out_f, in_f, bits, group, transposed in shapes:
        k = in_f // 2 if bits == 4 else in_f
        q = torch.randint(-128, 128, (out_f, k) if transposed else (k, out_f), generator=gen,
                          device=dev, dtype=torch.int8)
        n_groups = in_f // group
        s_shape = (1, out_f) if n_groups == 1 else (
            (out_f, n_groups) if transposed else (n_groups, out_f))
        s = (torch.rand(s_shape, generator=gen, device=dev) * 0.01 + 0.001).to(scales_dtype)
        x = torch.randn((rows, in_f), generator=gen, device=dev).to(dtype)
        kw = dict(bits=bits, group_size=group, transposed=transposed)
        sm.close("quant_matmul", m.dequant_matmul(x, q, s, **kw),
                 m.dequant_matmul_plain(x, q, s, **kw),
                 f"quant_matmul {name} {out_f}x{in_f} w{bits} g{group} "
                 f"{'transposed' if transposed else 'natural'} B={rows} {dtype} "
                 f"scales {scales_dtype}")
        if dev.type == "cuda":
            torch.cuda.synchronize()


def ffn_weights(torch, L, H, F, bits, gen, dev, dtype, scales_dtype=None):
    """Random act8 weights of the merged block, as check_a8 draws them."""
    k = 2 if bits == 4 else 1

    def q(o, i):
        return torch.randint(-128, 128, (L, o, i // k), generator=gen, device=dev,
                             dtype=torch.int8)

    def s(o):
        return (torch.rand((L, 1, o), generator=gen, device=dev) * 0.0015 + 0.0005).to(
            scales_dtype or torch.bfloat16)

    return dict(wo_q=q(H, H), wo_s=s(H),
                norm_w=(torch.rand((L, H), generator=gen, device=dev) + 0.5).to(dtype),
                w13_q=q(2 * F, H), w13_s=s(2 * F), w2_q=q(H, F), w2_s=s(H))


def check_ffn_block(sm: Smoke, H, F, rows: int, cases, gen, dev, dtype=None, L=2):
    """The merged FFN block (row 10) against its plain version phase by
    phase, through the kernel's scratch (see ACT_SLOPE). Each case is (bits,
    act, offset, layer)."""
    torch = sm.torch
    dtype = dtype or torch.bfloat16
    from metalchat_tpu_torch.ops import ffn_block as m

    weights = {}
    for bits, act, offset, layer in cases:
        if bits not in weights:
            weights[bits] = ffn_weights(torch, L, H, F, bits, gen, dev, dtype)
        w = weights[bits]
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(dtype)
                   for _ in range(2))
        scratch = {}
        got = m.ffn_block_stacked(attn, x, *w.values(), layer, bits=bits, act=act, eps=1e-5,
                                  offset=offset, scratch=scratch)
        x2, h = scratch["x2"], scratch["h"]
        what = (f"ffn_block H={H} F={F} w{bits} B={rows} {act} offset={offset} "
                f"layer={layer} {dtype}")
        sm.close("ffn_block", x2, m.wo_stage(attn, x, w["wo_q"][layer], w["wo_s"][layer],
                                             bits=bits), what + " phase A (x2)")
        h_ref, gate, up, sx_n = m.w13_stage(
            x2, w["norm_w"][layer], w["w13_q"][layer], w["w13_s"][layer], bits=bits, act=act,
            eps=1e-5, offset=offset)
        s13 = w["w13_s"][layer].reshape(-1).float()
        dg, du = (sx_n * s13[None, sl] * QMAX[bits] for sl in (slice(0, F), slice(F, None)))
        one_code = (ACT_SLOPE * up.abs() * dg + m.activation(gate, act).abs() * du
                    + ACT_SLOPE * dg * du)
        sm.close("ffn_block", h, h_ref, what + " phase B (h)", extra=one_code)
        sm.close("ffn_block", got, m.w2_stage(h, x2, w["w2_q"][layer], w["w2_s"][layer],
                                              bits=bits)[0], what + " phase C (out)")
        if dev.type == "cuda":
            torch.cuda.synchronize()


# Row 1 at the 8b-w4a8 decode shapes (wqkv and w13 fused, with the norm
# prologue), int4, at each row count; int8 at two of them.
A8_8B = [("wqkv", 6144, 4096, 4, True), ("wo", 4096, 4096, 4, False),
         ("w13", 28672, 4096, 4, True), ("w2", 4096, 14336, 4, False),
         ("lm_head", 128256, 4096, 4, False)]
A8_8B_W8 = [("wo", 4096, 4096, 8, False), ("wqkv", 6144, 4096, 8, True)]
A8_ROWS = (1, 2, 3, 5, 8, 16)
# The fixture's widths (hidden 384, intermediate 1024), an int8 lm_head.
A8_FIXTURE = [("wqkv", 768, 384, 4, True), ("wo", 384, 384, 4, False),
              ("w13", 2048, 384, 4, True), ("w2", 384, 1024, 4, False),
              ("lm_head", 384, 384, 8, False)]
# Row 11 at the 8b-int4 shapes (bench.py --config 8b-int4: group 32, the fused
# wqkv, w13 and lm_head transposed, wo and w2 not) and the 1b-int8 shapes
# (Llama-3.2-1B widths, int8, group 32).
QMM_8B_INT4 = [("wqkv", 6144, 4096, 4, 32, True), ("wo", 4096, 4096, 4, 32, False),
               ("w13", 28672, 4096, 4, 32, True), ("w2", 4096, 14336, 4, 32, False),
               ("lm_head", 128256, 4096, 4, 32, True)]
QMM_1B_INT8 = [("wqkv", 3072, 2048, 8, 32, True), ("wo", 2048, 2048, 8, 32, False),
               ("w13", 16384, 2048, 8, 32, True), ("w2", 2048, 8192, 8, 32, False),
               ("lm_head", 128256, 2048, 8, 32, True)]
# The fixture's widths, per-channel and group scales, both orientations.
QMM_FIXTURE = [("wqkv", 768, 384, 4, 32, True), ("wo", 384, 384, 4, 32, False),
               ("w13", 2048, 384, 8, 32, True), ("w2", 384, 1024, 8, 32, False),
               ("wo", 384, 384, 4, 384, False), ("w13", 2048, 384, 8, 384, True)]
# Row 10: (bits, act, offset, layer), layers 0 and L-1 of 2.
FFN_CASES = [(4, "silu", 0.0, 0), (4, "gelu_tanh", 1.0, 1), (8, "silu", 1.0, 1),
             (8, "gelu_tanh", 0.0, 0)]


# Lengths per row (the last row free): 1, a page edge and one past it, the
# table's last position, the serve run's range, and windows down to the new
# row alone.
PAGED_CASES_8B = [([1, 256, 257, 1024, 700, 513, 64, 1], None),
                  ([1024, 300, 257, 1, 256, 900, 5, 1], 100),
                  ([513, 1024, 2, 768, 129, 255, 1000, 1], 1)]
PAGED_CASES_FIXTURE = [([1, 16, 17, 1], None), ([128, 33, 5, 1], None),
                       ([40, 128, 12, 1], 10), ([17, 2, 128, 1], 1)]
# The kernel splits positions into chunks of SPLIT_CHUNK (32) that may cross
# pages: pages of 8 (4 to a chunk), of 48 (neither divides 32 nor is a
# multiple of it) and of 4 (the engine tests' size), lengths at the chunk
# edges (31, 32, 33, 65) and at page edges, windows whose lower edge lies
# inside a chunk (65 - 40 = 25, 96 - 50 = 46, 33 - 20 = 13).
PAGED_CASES_P8 = [([31, 32, 33, 65, 1, 128, 9, 1], None),
                  ([65, 33, 128, 32, 31, 100, 64, 1], 40),
                  ([100, 31, 64, 33, 2, 128, 17, 1], 1)]
PAGED_CASES_P48 = [([31, 32, 33, 65, 48, 49, 192, 1], None),
                   ([96, 65, 190, 33, 47, 1, 150, 1], 50),
                   ([192, 97, 32, 31, 145, 3, 65, 1], 1)]
PAGED_CASES_P4 = [([31, 32, 33, 1], None), ([65, 128, 3, 1], 20), ([33, 4, 64, 1], 1)]


# The decode kernel's chunk of positions a block
# (metalchat_tpu_torch.ops.decode_attention.SPLIT_CHUNK; phase kernels checks
# that they agree).
SPLIT_CHUNK = 32
C = SPLIT_CHUNK
# Lengths at chunk edges (C - 1, C, C + 1, 2C + 1) and at the 64-position
# edges, length 1, the main path's lengths (513-576), the full context,
# windows down to the new row alone and windows whose lower edge lies inside
# a chunk, and zeroed caches.
DECODE_CASES_8B = [([1], None, "random"), ([C - 1], None, "random"), ([C], None, "random"),
                   ([C + 1], None, "random"), ([2 * C + 1], None, "random"),
                   ([64], None, "random"), ([65], None, "random"),
                   ([576], None, "random"), ([1024], None, "random"),
                   ([700], 100, "random"), ([577], 3 * C - 7, "random"),
                   ([576], 1, "random"), ([577], 2, "random"),
                   ([576], None, "zeros"), ([1024], None, "zeros")]
DECODE_CASES_FIXTURE = [([1, 64, 65], None, "random"), ([200, 17, 256], 50, "random"),
                        ([2, 64, 130], None, "zeros"), ([65, 128, 256], 1, "random")]
# Flash: (start_pos, window); a list is one start per batch row.
FLASH_CASES_FIXTURE = [(0, None), ([0, 17, 64], None), (0, 20), ([63, 1, 0], 1)]
# The serve path's shapes: 8 rows at per-row lengths up to the context (1024),
# one free row at length 1; flash over 256-token chunks at per-row offsets.
# The last case leaves most of the 32 chunks of every row dead.
DECODE_CASES_SERVE = [([1, 64, 65, 300, 577, 1024, 700, 129], None, "random"),
                      ([1024, 256, 257, 1, 900, 513, 64, 1], 100, "random"),
                      ([600, 1024, 2, 768, 129, 255, 1000, 1], None, "zeros"),
                      ([1, C, C + 1, 3, 2 * C + 1, 1, C - 1, 5], None, "random")]
READ_CASES_SERVE = [([1, 64, 65, 300, 577, 1024, 700, 129], None),
                    ([1024, 256, 257, 1, 900, 513, 64, 1], 100),
                    ([600, 1024, 2, 768, 129, 255, 1000, 1], 1)]
READ_CASES_FIXTURE = [([1, 64, 65], None), ([200, 17, 256], 50), ([65, 128, 256], 1)]
FLASH_CASES_SERVE = [([0, 256, 512, 768, 100, 37, 640, 0], None),
                     ([768, 0, 300, 1, 512, 700, 256, 64], None)]
# Flash at the 8B shapes: 512 tokens from 0 and from an unaligned start,
# windows; then a ragged S (the serve path's last chunk) from unaligned starts.
FLASH_CASES_8B = [(0, None), (100, None), (0, 128), (64, 1)]
FLASH_RAGGED_S = 137
FLASH_CASES_RAGGED = [(100, None), (37, 70), (0, 1)]


def phase_kernels(sm: Smoke):
    torch = sm.torch
    from metalchat_tpu_torch.ops.decode_attention import SPLIT_CHUNK as kernel_chunk

    sm.expect(kernel_chunk == SPLIT_CHUNK,
              f"decode chunk {kernel_chunk} != chip_smoke.SPLIT_CHUNK {SPLIT_CHUNK}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # One row (the generate path's instance), then 2-16 rows (a8_quantize and
    # the tensor-core matvec: one n-tile up to 8 rows, two above; the serve
    # decode step is 8 rows), int4, and int8 at 1 and 8 rows.
    for rows in A8_ROWS:
        check_a8(sm, A8_8B, rows, gen, dev)
    for rows in (1, 8):
        check_a8(sm, A8_8B_W8, rows, gen, dev)
    check_a8(sm, A8_FIXTURE, 3, gen, dev)
    check_decode(sm, 1, 32, 8, 1024, 128, DECODE_CASES_8B, gen, dev)
    check_decode(sm, 8, 32, 8, 1024, 128, DECODE_CASES_SERVE, gen, dev)
    check_decode(sm, 3, 6, 3, 256, 64, DECODE_CASES_FIXTURE, gen, dev)
    check_decode_read(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE, gen, dev)
    check_decode_read(sm, 8, 32, 8, 1024, 128, READ_CASES_SERVE, gen, dev, kv="int8")
    check_decode_read(sm, 3, 6, 3, 256, 64, READ_CASES_FIXTURE, gen, dev, torch.float32)
    check_flash(sm, 1, 512, 32, 8, 1024, 128, FLASH_CASES_8B, gen, dev)
    check_flash(sm, 1, FLASH_RAGGED_S, 32, 8, 1024, 128, FLASH_CASES_RAGGED, gen, dev)
    check_flash(sm, 8, 256, 32, 8, 1024, 128, FLASH_CASES_SERVE, gen, dev)
    check_flash(sm, 3, 48, 6, 3, 256, 64, FLASH_CASES_FIXTURE, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 256, 4, PAGED_CASES_8B, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 8, 16, PAGED_CASES_P8, gen, dev)
    check_paged(sm, 8, 32, 8, 128, 48, 4, PAGED_CASES_P48, gen, dev)
    check_paged(sm, 4, 6, 3, 64, 16, 8, PAGED_CASES_FIXTURE, gen, dev)
    check_paged(sm, 4, 6, 3, 64, 4, 32, PAGED_CASES_P4, gen, dev)
    for rows in (1, 8, 32):
        check_qmm(sm, QMM_8B_INT4, rows, gen, dev)
        check_qmm(sm, QMM_1B_INT8, rows, gen, dev)
    check_qmm(sm, QMM_FIXTURE, 3, gen, dev, torch.float32, torch.float32)
    for rows in (1, 8):
        check_ffn_block(sm, 4096, 14336, rows, FFN_CASES, gen, dev)
    check_graph_replay(sm, 2, 32, 8, 1024, 128, gen, dev)
    print("max |kernel - plain| in bf16 (raw int32 and cache bytes exact; a8_quantize "
          "in int8 code quanta): "
          + ", ".join(f"{k} {v:.3g} ({sm.share[k]:.3g} of its limit)"
                      for k, v in sm.err.items()))


# -- phase 4: the fixture end to end ---------------------------------------------

def phase_fixture(sm: Smoke):
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    outs = {}
    for device in ("cuda", "cpu"):
        params, cfg, fixture = fixture_params(torch, device)
        prompts = torch.from_numpy(
            np.load(fixture / "eval_tokens.npy")[:3 * 48].astype(np.int64).reshape(3, 48))
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
    sm.expect(all(counts[k] > 0 for k in GENERATE_KERNELS),
              f"fixture: a kernel never ran {counts}")
    # Decode runs 3 rows: every fused matvec call quantizes its rows once.
    sm.expect(counts["a8_quantize"] == counts["a8_matvec"],
              f"fixture: a8_quantize {counts['a8_quantize']} != a8_matvec {counts['a8_matvec']}")


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


def drive_generate(sm: Smoke, dev_name: str, label: str, cfg, params, per_step,
                   ffn_block: bool = False, ctx: int = 1024, prompt_len: int = 512,
                   new: int = 64):
    """One user's request through `generate` at full width: int8 KV, batch
    1, a random 512-token prompt, then 64 greedy decode steps. Prints decode
    tok/s, TTFT, bytes a token and the HBM share (bench.py's accounting).
    Launches are read around the timed runs and held exactly: ``per_step``
    a decode step, flash once a layer a prefill, every other kernel never."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev)

    def run(n_new):
        cache = QuantizedKVCache.create(cfg, 1, ctx, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache,
                       ffn_block=ffn_block)
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
              and bool((out < cfg.vocab_size).all()), f"{label}: bad tokens {out.shape}")
    want = dict.fromkeys(counts, 0)
    want.update({k: n * new for k, n in per_step.items()})
    want["flash_attention"] = 2 * cfg.num_layers
    sm.tok_s[label] = tok_s
    print(f"{label}: decode {tok_s:.2f} tok/s, TTFT {1e3 * ttft:.2f} ms "
          f"(prompt {prompt_len}), {bpt / 1e9:.4f} GB/token (bound "
          f"{1e3 * bpt / rate:.4f} ms a step), {tok_s * bpt / rate:.4f} of "
          f"{rate / 1e12:.2f} TB/s HBM, launches {counts}")
    sm.expect(counts == want, f"{label}: launches {counts} != expected {want}")
    return cfg, params, cache, counts, prompt_len + new, prompt


def make_8b(sm: Smoke, label: str, **quant):
    """Llama-3.1-8B geometry at full width, context 1024, random quantized
    weights from a seeded torch.Generator, wqkv and w13 fused."""
    torch = sm.torch
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    cfg = LlamaConfig.llama31_8b(max_seq_len=1024)
    t0 = time.perf_counter()
    params = fuse_projections(init_random_quantized_params(
        cfg, max_seq_len=1024, seed=0, device=torch.device("cuda"), **quant), cfg)
    torch.cuda.synchronize()
    print(f"{label} params: {weight_bytes(params) / 1e9:.3f} GB of weights, made in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def phase_main(sm: Smoke, dev_name: str):
    """8b-w4a8 (bench.py:78-84): per-channel int4, int8 activations."""
    cfg, params = make_8b(sm, "8b-w4a8", bits=4, group_size=None, act_bits=8)
    L = cfg.num_layers
    return drive_generate(sm, dev_name, "8b-w4a8 main path", cfg, params,
                          {"a8_matvec": 4 * L + 1, "a8_quantize": 0,
                           "decode_attention_update": L})


def phase_main_int4(sm: Smoke, dev_name: str):
    """8b-int4 (bench.py:73-77): weight-only int4, group 32. Every decode
    linear is the dequant-matmul kernel (4 a layer and lm_head); the prompt
    takes the dequantized weights and torch.matmul."""
    cfg, params = make_8b(sm, "8b-int4", bits=4, group_size=32)
    L = cfg.num_layers
    layout = {n: (tuple(w.q.shape), w.transposed) for n, w in
              [*params["layers"].items(), ("lm_head", params["lm_head"])]
              if hasattr(w, "q")}
    print(f"8b-int4 layouts (q shape, transposed): {layout}")
    return drive_generate(sm, dev_name, "8b-int4", cfg, params,
                          {"quant_matmul": 4 * L + 1, "decode_attention_update": L})


def phase_main_ffn_block(sm: Smoke, main, dev_name: str):
    """Phase main's 8b-w4a8 params with the merged FFN block: one ffn_block
    launch a layer, a8_matvec for wqkv and lm_head."""
    cfg, params = main[0], main[1]
    L = cfg.num_layers
    run = drive_generate(sm, dev_name, "8b-w4a8 ffn_block", cfg, params,
                         {"ffn_block": L, "a8_matvec": L + 1, "a8_quantize": 0,
                          "decode_attention_update": L},
                         ffn_block=True)
    print(f"8b-w4a8 decode: ffn_block {sm.tok_s['8b-w4a8 ffn_block']:.2f} tok/s beside "
          f"unmerged {sm.tok_s['8b-w4a8 main path']:.2f} tok/s (one run each, the same "
          "params and prompt)")
    # The two routes in turns (unmerged, merged, merged, unmerged), 64 decode
    # steps each after the same prefill: the host's pace drifts between runs.
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine.generate import generate

    prompt = run[5]
    turns = []
    for merged in (False, True, True, False):
        times = []
        for n_new in (1, 65):
            cache = QuantizedKVCache.create(cfg, 1, 1024, device=torch.device("cuda"))
            torch.cuda.synchronize()
            t = time.perf_counter()
            generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache, ffn_block=merged)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        turns.append((merged, 64 / (times[1] - times[0])))
    print("8b-w4a8 decode tok/s in turns: " + ", ".join(
        f"{'ffn_block' if m else 'unmerged'} {v:.2f}" for m, v in turns))
    phase_profile(sm, run, "8b-w4a8 ffn_block", ffn_block=True, prefill=False)
    return run


# -- phases 6-8: serving ------------------------------------------------------

W4A8 = dict(bits=4, group_size=None, act_bits=8)


def fixture_params(torch, device, dtype=None, quant=None):
    """The trained fixture quantized by ``quant`` (W4A8 by default: per-channel
    int4, int8 activations), fused, activations in ``dtype`` (bf16 by
    default)."""
    from pathlib import Path

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.quant.quantize import quantize_params

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / "pyllama_10m"
    cfg = load_config(fixture / "config.json")
    params = load_params(open_safetensors(fixture), cfg, dtype=dtype or torch.bfloat16,
                         max_seq_len=256, device=device)
    return fuse_projections(quantize_params(params, **(quant or W4A8)), cfg), cfg, fixture


# fixture-int runs in bf16, the activation dtype of the main paths. Its
# greedy tokens are compared on eval_tokens[1440:1584]: bf16 logits are
# coarse, and over most slices of the eval tokens some mode's top two logits
# at one of the 48 positions compared lie within 0-2 bf16 steps of each
# other, where two sum orders may part (eval_tokens[:144]: 2 steps in
# "w8 g32", at which card and CPU parted at the 7th token of request 0,
# 5.875 against 5.84375). This slice keeps every gap at 15 steps or more
# (experiments/fixture_tie_scan.py, on the CPU).
FIXTURE_INT_DTYPE = "bfloat16"
FIXTURE_INT_PROMPTS = slice(1440, 1584)
# Beside the tokens, the logits step by step on eval_tokens[:144], which does
# not rest on a tie-free slice: a prefill and FIXTURE_INT_LOGIT_STEPS - 1
# decode steps fed the CPU's greedy tokens on both devices, the last
# position's logits of each step on the card within one bf16 step of the
# CPU's plus LOGIT_SHARE of the row's largest |logit|. Row 11's own schedule
# (emulated on the CPU, tests/test_torch_qmm_mma.py) moves them by at most
# 0.0051 of the largest beyond one step in "w8 g32" and "w4 g32"; a split
# dropped from the k-split merge moves them by 0.89.
FIXTURE_INT_LOGIT_PROMPTS = slice(0, 144)
FIXTURE_INT_LOGIT_STEPS = 16
LOGIT_SHARE = 2 ** -5
# fixture-int: the modes, as (quantization, generate's ffn_block). Weight-only
# group-32 leaves take the dequant-matmul kernel at decode (3 rows) and a
# dense product for the 144-row prompt; lm_head is quantized too.
FIXTURE_INT_MODES = {
    "w4 g32": (dict(bits=4, group_size=32, quantize_lm_head=True), False),
    "w8 g32": (dict(bits=8, group_size=32, quantize_lm_head=True), False),
    "w4a8 ffn_block": (W4A8, True),
}


def teacher_forced_logits(params, cfg, prompts, tokens, ffn_block: bool = False):
    """``[steps, B, vocab]`` f32 on the CPU, ``steps = tokens.shape[1]``: the
    last position's logits of a prefill over ``prompts``, then of one decode
    step per column of ``tokens`` but the last, each fed that column, on an
    int8 cache as ``generate`` makes it."""
    import torch

    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    device = params["final_norm"].device
    prompts, tokens = prompts.to(device), tokens.to(device)
    b, s = prompts.shape
    steps = tokens.shape[1]
    with torch.no_grad():
        cache = QuantizedKVCache.create(cfg, b, min(cfg.max_seq_len, s + steps),
                                        device=device)
        logits, cache = forward(params, cache, prompts, 0, cfg, ffn_block=ffn_block)
        out = [logits[:, -1].float().cpu()]
        for i in range(steps - 1):
            logits, cache = forward(params, cache, tokens[:, i:i + 1], s + i, cfg,
                                    ffn_block=ffn_block)
            out.append(logits[:, -1].float().cpu())
    return torch.stack(out)


def check_logits(sm: Smoke, what: str, got, want) -> float:
    """Each step's logits within one bf16 step of each value plus
    ``LOGIT_SHARE`` of the row's largest |logit|; returns the worst share of
    that limit."""
    torch = sm.torch
    diff = (got - want).abs()
    limit = RTOL["bfloat16"] * want.abs() + LOGIT_SHARE * want.abs().amax(-1, keepdim=True)
    share = (diff / limit).max().item()
    sm.expect(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    sm.expect(share <= 1.0, f"{what}: {int((diff > limit).sum())} logits beyond the limit "
              f"(max abs err {diff.max().item()}, {share:.3g} of the limit)")
    return share


def phase_fixture_int(sm: Smoke, dtype_name: str):
    """The fixture through `generate` in each FIXTURE_INT_MODES mode, the
    kernels on the card against the plain path on the CPU: 3 requests of 48
    tokens, 64 greedy tokens; the first 16 of each request must agree. Then
    each step's logits on FIXTURE_INT_LOGIT_PROMPTS, fed the CPU's tokens
    (``check_logits``)."""
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    dtype = getattr(torch, dtype_name)
    results = {}
    for mode, (quant, ffn_block) in FIXTURE_INT_MODES.items():
        outs, logits, forced = {}, {}, None
        for device in ("cpu", "cuda"):
            params, cfg, fixture = fixture_params(torch, device, dtype, quant)
            tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
            prompts = torch.from_numpy(tokens[FIXTURE_INT_PROMPTS].reshape(3, 48))
            reset_launch_counts()
            outs[device] = generate(params, cfg, prompts, max_new_tokens=64,
                                    quantized_kv=True, ffn_block=ffn_block).cpu()
            if device == "cuda":
                counts = launch_counts()
            old = torch.from_numpy(tokens[FIXTURE_INT_LOGIT_PROMPTS].reshape(3, 48))
            if forced is None:  # the CPU's greedy tokens
                forced = generate(params, cfg, old, max_new_tokens=FIXTURE_INT_LOGIT_STEPS,
                                  quantized_kv=True, ffn_block=ffn_block).cpu()
            logits[device] = teacher_forced_logits(params, cfg, old, forced, ffn_block)
        agree = (outs["cuda"] == outs["cpu"]).float().mean().item()
        first16 = bool(torch.equal(outs["cuda"][:, :16], outs["cpu"][:, :16]))
        print(f"fixture-int {mode} {dtype_name}: card vs CPU plain agreement {agree:.4f}, "
              f"first 16 identical: {first16}, launches {counts}; logits step by step on "
              f"eval_tokens[:144]: max abs err "
              f"{(logits['cuda'] - logits['cpu']).abs().max().item()}", flush=True)
        share = check_logits(sm, f"fixture-int {mode} logits on eval_tokens[:144]",
                             logits["cuda"], logits["cpu"])
        print(f"fixture-int {mode}: logits worst {share:.4f} of the limit")
        sm.expect(first16, f"fixture-int {mode}: first 16 greedy tokens differ card vs CPU")
        kernel = "ffn_block" if ffn_block else "quant_matmul"
        sm.expect(counts[kernel] > 0 and counts["decode_attention_update"] > 0,
                  f"fixture-int {mode}: a kernel never ran {counts}")
        results[mode] = counts
    return results


SERVE_FIXTURE = dict(max_slots=3, max_seq_len=256, prefill_chunk=32, decode_burst=4)
SERVE_FIXTURE_MODES = {"paged": dict(cache_mode="paged", page_size=16),
                       "dense": dict(quantized_kv=True),
                       "dense-act": dict()}  # KV in the activation dtype


def phase_serve_fixture(sm: Smoke):
    """6 greedy requests of mixed lengths through the engine, paged, dense
    int8 and dense in the activation dtype, on the card and on the CPU plain
    path, at f32 activations:
    the comparison holds the engine and the kernels' f32 instances. (In
    bf16 the 70-token request meets a near tie at its 15th token: on the
    card token 61 scores 6.6875 over token 41's 6.59375, on the CPU token
    41 scores 6.625 over token 61's 6.59375, paged and dense alike.)"""
    torch = sm.torch
    import numpy as np

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts

    tokens = None
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        params, cfg, fixture = fixture_params(torch, device, torch.float32)
        if tokens is None:
            tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
        prompts = [tokens[1000 + 100 * i:1000 + 100 * i + n].tolist()
                   for i, n in enumerate((5, 70, 35, 15, 48, 120))]
        for mode, kw in SERVE_FIXTURE_MODES.items():
            engine = ContinuousBatchingEngine(params, cfg, **SERVE_FIXTURE, **kw)
            reset_launch_counts()
            done = engine.run([Request(prompt=p, max_new_tokens=16) for p in prompts])
            counts[device, mode] = launch_counts()
            out[device, mode] = [c.tokens for c in done.values()]
            sm.expect(all(c.finish_reason == "length" for c in done.values()),
                      f"serve-fixture {device} {mode}: {[c.finish_reason for c in done.values()]}")

    def first16(a, b):
        return all(x[:16] == y[:16] for x, y in zip(out[a], out[b]))

    def first_diff(a, b):
        return [next((i for i, (s, t) in enumerate(zip(x, y)) if s != t), None)
                for x, y in zip(out[a], out[b])]

    def agree(a, b):
        pairs = [(s, t) for x, y in zip(out[a], out[b]) for s, t in zip(x, y)]
        return sum(s == t for s, t in pairs) / len(pairs)

    for mode in SERVE_FIXTURE_MODES:
        print(f"serve-fixture {mode}: card vs CPU plain agreement "
              f"{agree(('cuda', mode), ('cpu', mode)):.4f}, first 16 identical: "
              f"{first16(('cuda', mode), ('cpu', mode))} (first difference per request "
              f"{first_diff(('cuda', mode), ('cpu', mode))}), launches {counts['cuda', mode]}")
        sm.expect(first16(("cuda", mode), ("cpu", mode)),
                  f"serve-fixture {mode}: first 16 greedy tokens differ card vs CPU")
    print(f"serve-fixture paged vs dense on the card: agreement "
          f"{agree(('cuda', 'paged'), ('cuda', 'dense')):.4f}")
    sm.expect(first16(("cuda", "paged"), ("cuda", "dense")),
              "serve-fixture: paged and dense differ on the card")
    for mode, attn in (("paged", "paged_decode_attention_update"),
                       ("dense", "decode_attention_update"), ("dense-act", "decode_attention")):
        c = counts["cuda", mode]
        sm.expect(c[attn] > 0 and c["a8_matvec"] > 0 and c["flash_attention"] > 0,
                  f"serve-fixture {mode}: a kernel never ran {c}")
    return {mode: counts["cuda", mode] for mode in SERVE_FIXTURE_MODES}


def serve_workload(cfg, n: int = 24, new: int = 96):
    """`bench.py --mode serve`'s requests: prompt lengths from
    random.Random(0).randint(48, 640), prompt [1 + i % 100] * n, greedy."""
    import random

    from metalchat_tpu_torch.engine import Request

    rng = random.Random(0)
    hi = min(640, cfg.max_seq_len - new - 8)
    lengths = [rng.randint(min(48, hi), hi) for _ in range(n)]
    return [Request(prompt=[1 + (i % 100)] * k, max_new_tokens=new)
            for i, k in enumerate(lengths)]


def serve_bytes_per_token(cfg, params, slots: int) -> float:
    """bench.py's bytes_per_token for an int8 cache: weights but the
    embedding table, one embedding row, and each row's KV payload and
    scales at the average fill max_seq_len / 2."""
    kv_row = 2 * cfg.num_layers * cfg.num_kv_heads * (cfg.max_seq_len / 2) * (cfg.head_dim + 4)
    return weight_bytes(params) + cfg.hidden_size * 2 + slots * kv_row


def phase_serve(sm: Smoke, main, rate: float):
    """8b-w4a8 behind the engine with bench.py's serve workload, paged then
    dense int8. Launch counts read around the measured run only."""
    torch = sm.torch
    from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
    from metalchat_tpu_torch.ops import launch_counts, reset_launch_counts
    from metalchat_tpu_torch.utils.profiling import Meter

    cfg, params = main[0], main[1]
    L = cfg.num_layers
    slots, new = 8, 96
    requests = serve_workload(cfg, new=new)
    bpt = serve_bytes_per_token(cfg, params, slots)
    roof = rate / bpt * slots
    runs = {}
    for mode, kw in (("paged", dict(cache_mode="paged", page_size=256)),
                     ("dense", dict(quantized_kv=True))):
        engine = ContinuousBatchingEngine(params, cfg, max_slots=slots, max_seq_len=1024,
                                          decode_burst=32, prefill_chunk=256, **kw)
        engine.run([Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
                    for r in requests[:2]])  # warm-up
        engine.meter = Meter()
        engine.counters = dict.fromkeys(engine.counters, 0)
        engine.prefill_shapes.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        engine.meter.start()
        t0 = time.perf_counter()
        done = engine.run([Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
                           for r in requests])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        m = engine.metrics()
        total = sum(len(c.tokens) for c in done.values())
        tok_s = total / wall
        steps = m["decode_steps"]
        # Prompt chunks by shape: windows of <= 16 tokens take the decode
        # path (the matvec kernel when B*S <= 16 rows; the attention kernel
        # when S == 1), longer ones flash attention.
        shapes = engine.prefill_shapes
        short = sum(n for (b, s), n in shapes.items() if s <= 16 and b * s <= 16)
        short_multi = sum(n for (b, s), n in shapes.items() if s <= 16 and 2 <= b * s <= 16)
        single = sum(n for (b, s), n in shapes.items() if s == 1)
        long_ = sum(n for (b, s), n in shapes.items() if s > 16)
        attn = "paged_decode_attention_update" if mode == "paged" else "decode_attention_update"
        # Every decode step runs all 8 slots' rows: a8_quantize once for
        # each fused matvec call of 2-16 rows.
        want = {"a8_matvec": (4 * L + 1) * (steps + short),
                "a8_quantize": (4 * L + 1) * (steps + short_multi), attn: L * (steps + single),
                "flash_attention": L * long_}
        print(f"serve 8b-w4a8 {mode}: {len(done)} requests, {total} tokens in {wall:.3f} s = "
              f"{tok_s:.2f} tok/s, {tok_s / roof:.4f} of the full-slot decode roofline "
              f"({roof:.1f} tok/s at {bpt / 1e9:.4f} GB a step, {rate / 1e12:.2f} TB/s); "
              f"TTFT p50 {1e3 * m['ttft_p50']:.1f} ms p99 {1e3 * m['ttft_p99']:.1f} ms, "
              f"service TTFT p50 {1e3 * m['service_ttft_p50']:.1f} ms p99 "
              f"{1e3 * m['service_ttft_p99']:.1f} ms; counters "
              f"{ {k: m[k] for k in engine.counters} }; prompt chunks by shape "
              f"{dict(shapes)} ({short} short, {long_} long); launches {counts}",
              flush=True)
        sm.expect(all(c.error is None and c.finish_reason == "length"
                      and len(c.tokens) == new for c in done.values())
                  and len(done) == len(requests),
                  f"serve {mode}: {[(c.finish_reason, len(c.tokens)) for c in done.values()]}")
        sm.expect(sum(shapes.values()) == m["prefill_dispatches"] + m["combined_dispatches"],
                  f"serve {mode}: prompt chunks {dict(shapes)} vs counters {m}")
        sm.expect(all(counts[k] == v for k, v in want.items()),
                  f"serve {mode}: launches {counts} != expected {want}")
        if mode == "paged":
            sm.expect(engine.allocator.free_pages == engine.num_pages,
                      f"serve paged: {engine.num_pages - engine.allocator.free_pages} "
                      "pages never freed")
        if mode == "paged":  # one decode dispatch (8 steps), every slot decoding
            fill_slots(engine, requests, slots)
            engine.decode_burst = 8
            profile_window(torch, f"serve {mode}, one decode dispatch of {slots} rows",
                           engine.step)
            for rid in list(engine._completions):
                engine.cancel(rid)
        runs[mode] = dict(engine=engine, counts=counts, tok_s=tok_s, metrics=m)
    return runs


def fill_slots(engine, requests, slots: int) -> None:
    """Admit and prefill one request per slot, up to their first token."""
    from metalchat_tpu_torch.engine import Request

    for r in requests[:slots]:
        engine.submit(Request(prompt=list(r.prompt), max_new_tokens=64))
    for _ in range(100):
        if len(engine._slots) == slots and all(s.decoding for s in engine._slots.values()):
            return
        engine.step()
    raise AssertionError("serve: the slots did not fill")


class ByteTokenizer:
    """Byte-level tokenizer: ids are bytes (the fixture was trained on them)."""

    def encode(self, text, allow_special=False):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")

    def token_bytes(self, token_id):
        return bytes([int(token_id) % 256])


def phase_http(sm: Smoke):
    """The fixture (paged, on the card) behind InferenceServer on 127.0.0.1."""
    torch = sm.torch
    import urllib.request

    from metalchat_tpu_torch.engine import ContinuousBatchingEngine
    from metalchat_tpu_torch.engine.http import InferenceServer

    params, cfg, _ = fixture_params(torch, "cuda")
    engine = ContinuousBatchingEngine(params, cfg, **SERVE_FIXTURE,
                                      **SERVE_FIXTURE_MODES["paged"])
    server = InferenceServer(engine, ByteTokenizer(), model_name="fixture")
    port = server.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    try:
        payload = {"prompt": "The history of the ", "max_tokens": 16}
        with post("/v1/completions", payload) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        chunks = []
        with post("/v1/completions", {**payload, "stream": True}) as r:
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: "):
                    chunks.append(json.loads(line[6:])["choices"][0]["text"])
        with post("/v1/chat/completions", {"messages": [{"role": "user", "content": "Hi"}],
                                           "max_tokens": 8}) as r:
            chat = json.loads(r.read())
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        server.stop()
    print(f"http: blocking {text!r}, SSE equal: {''.join(chunks) == text}, chat "
          f"{chat['choices'][0]['message']['content']!r}, health {health}, metrics "
          f"requests {metrics.get('requests')}, decode_steps {metrics.get('decode_steps')}")
    sm.expect(len(text) > 0 and "".join(chunks) == text, "http: SSE text != blocking text")
    sm.expect(chat["object"] == "chat.completion" and health == {"status": "ok"}
              and metrics.get("requests") == 3.0, f"http: {chat} {health} {metrics}")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_window(torch, name: str, fn) -> None:
    """torch.profiler over ``fn()``: the device's busy share of the host's
    wall time and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device events but the ranges of `record_function` annotations (the
    # engine's "prefill" / "decode burst"), which span whole calls.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"  profile {name}: device busy share not measured "
              "(the profiler recorded no device activity)")
        return
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = {}
    for e in kernels:
        key = next((k for k in ("a8_matvec", "a8_mma", "a8_quantize", "decode_kernel",
                                "flash", "paged_kernel", "qmm_", "ffn_block") if k in e.name),
                   e.name[:48])
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:7]
    print(f"  profile {name}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy / wall_us:.4f} of wall), {len(kernels)} "
          "kernels; device ms by kernel: "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top))


def phase_profile(sm: Smoke, main, label: str = "8b-w4a8", ffn_block: bool = False,
                  prefill: bool = True):
    """Where a generate run's time goes: torch.profiler over one 512-token
    prefill and 8 decode steps of the 8B model, the device's busy share of
    the host's wall time and device time by kernel."""
    torch = sm.torch
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.models.transformer import forward

    cfg, params, _, _, _, prompt = main
    dev = torch.device("cuda")
    cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
    s = prompt.shape[1]
    step = lambda: forward(params, cache, prompt, 0, cfg)  # noqa: E731
    if prefill:
        profile_window(torch, f"{label} prefill", step)
    else:
        step()
    profile_window(torch, f"{label} decode x8", lambda: [
        forward(params, cache, prompt[:, i:i + 1], s + i, cfg, ffn_block=ffn_block)
        for i in range(8)])


def a8_calls(torch, cfg, params, rows: int, gen):
    """One decode step's matvec calls at ``rows`` rows: (name, packed
    weights, scales, input, norm stack or None, calls a step)."""
    dev = torch.device("cuda")
    layers, lm, L = params["layers"], params["lm_head"], cfg.num_layers
    x = torch.randn((rows, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    x2 = torch.randn((rows, cfg.intermediate_size), generator=gen, device=dev).to(torch.bfloat16)
    return [("wqkv", layers["wqkv"].q, layers["wqkv"].scales, x, layers["attn_norm"], L),
            ("wo", layers["wo"].q, layers["wo"].scales, x, None, L),
            ("w13", layers["w13"].q, layers["w13"].scales, x, layers["ffn_norm"], L),
            ("w2", layers["w2"].q, layers["w2"].scales, x2, None, L),
            ("lm_head", lm.q[None], lm.scales[None], x, None, 1)]


def a8_bound(pq, norm, rows: int, rate: float):
    """Least time of one fused matvec call: the packed weights and scales
    read once, the bf16 rows in and out (and the norm weights)."""
    _, out_f, k = pq.shape
    in_f = 2 * k
    nbytes = (out_f * k + out_f * 2 + rows * (in_f + out_f) * 2
              + (in_f * 2 if norm is not None else 0))
    return bound(nbytes, 2 * rows * in_f * out_f, "int8", rate)


def phase_timing(sm: Smoke, main, rate: float):
    """Each kernel at the main path's shapes: kernel (CUDA graph replay),
    plain version (eager), one library call (graph), and the bound."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from metalchat_tpu_torch.ops.quant_matmul import unpack_int4

    cfg, params, cache, counts, length, _ = main
    dev = torch.device("cuda")
    L = cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []

    # a8_matvec: one decode step's calls (4 per layer + lm_head).
    a8 = a8_calls(torch, cfg, params, 1, gen)
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
        unpacked = [unpack_int4(pq[i], -1).contiguous() for i in range(n_lib)]
        xq17 = torch.randint(-127, 128, (17, in_f), generator=gen, device=dev,
                             dtype=torch.int8)
        lib = sm.device_ms(lambda i: torch._int_mm(xq17, unpacked[i % n_lib].t()), 32)
        sm.a8_library[name] = lib
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
        b_ms, b_by = a8_bound(pq, norm, 1, rate)
        print(f"  a8_matvec {name} [{out_f}x{in_f} w4]: {ms * 1e3:.2f} us "
              f"(bound {b_ms * 1e3:.2f} us, {b_by}; plain {plain * 1e3:.1f} us; "
              f"_int_mm M=17 int8 {lib * 1e3:.2f} us) x{per_step}/token")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", b_ms)):
            step[key] += per_step * val
    print(f"  a8_matvec raw mode (not on the main path), one decode step's {4 * L + 1} "
          f"shapes: {raw_step['ms']:.4f} ms (bound {raw_step['bound_ms']:.4f} ms, bytes; "
          f"plain {raw_step['plain_ms']:.3f} ms)")
    rows.append(dict(row=1, name="a8_matvec", source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                     replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262",
                     bound_by="bytes", unit=f"one decode step ({4 * L + 1} calls)",
                     **step))
    rows.append(dict(row=2, name="a8_matvec_raw", counter="a8_matvec_raw",
                     source="metalchat_tpu_torch/csrc/a8_matvec.cu",
                     replaces="metalchat_tpu/ops/a8_matvec_pallas.py:187", bound_by="bytes",
                     library_ms=step["library_ms"], max_abs_err=0.0,
                     unit=f"one decode step's {4 * L + 1} shapes, int8 rows in, int32 out "
                          "(raw mode, on no driven path; library as row 1)", **raw_step))

    # decode_attention_update: one decode step (one call per layer) at the
    # main path's last length; first at lengths 64 and 1024, the kernel and
    # its yardstick only (the cache past the main path's length is zeros).
    q = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    args = (cache.k, cache.v, cache.k_scale, cache.v_scale)

    def decode_update(n: int):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        ms = sm.device_ms(lambda i: dm.decode_attention_update_quantized_stacked(
            q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 64)
        kd = dequantize_kv(cache.k[0, :, :, :n], cache.k_scale[0, :, :, :n])
        vd = dequantize_kv(cache.v[0, :, :, :n], cache.v_scale[0, :, :, :n])
        # Library yardstick: SDPA over the dequantized bf16 K/V of one layer,
        # its KV heads repeated to the query heads outside the timed call.
        kd, vd = (t.repeat_interleave(nh // nkv, dim=1) for t in (kd, vd))
        lib = sm.device_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd), 64)
        nbytes = (2 * nkv * n * (hd + 4) + 2 * nh * hd * 2 + 2 * nkv * hd * 2
                  + 2 * nkv * (hd + 4))
        return (ms, lib, *bound(nbytes, 4 * nh * hd * n, "f32", rate), lens)

    for n in (64, 1024):
        ms, lib, b_ms, b_by, _ = decode_update(n)
        print(f"  decode_attention_update [length {n}, T {cache.k.shape[3]}]: "
              f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}; sdpa bf16 "
              f"{lib * 1e3:.2f} us) x{L}/token: {L * ms:.5f} ms a step, sdpa "
              f"{L * lib:.5f}")
    ms, lib, b_ms, b_by, lens = decode_update(length)
    plain = sm.eager_ms(lambda i: dm.decode_attention_update_plain(
        q, kn, kn, *args, i % L, lens, scale=hd ** -0.5), 5)
    print(f"  decode_attention_update [length {length}, T {cache.k.shape[3]}]: "
          f"{ms * 1e3:.2f} us (bound {b_ms * 1e3:.3f} us, {b_by}; plain "
          f"{plain * 1e3:.1f} us; sdpa bf16 {lib * 1e3:.2f} us) x{L}/token")
    rows.append(dict(row=3, name="decode_attention_update",
                     source="metalchat_tpu_torch/csrc/decode_attention.cu",
                     replaces="metalchat_tpu/ops/decode_attention_pallas.py:598",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one decode step ({L} calls, length {length})"))

    # flash_attention at hd=64 (the fixture's and Llama-3.2-1B's head size),
    # 32 heads over 8 kv heads, random bf16, a 512-token prefill from 0:
    # the kernel and its yardstick only.
    S = 512
    q64, k64, v64 = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((1, S, nh, 64), (1, nkv, S, 64), (1, nkv, S, 64)))
    ms64 = sm.device_ms(lambda i: flash_attention(q64, k64, v64, 0, scale=0.125), 8)
    k64, v64 = (t.repeat_interleave(nh // nkv, dim=1) for t in (k64, v64))
    lib64 = sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q64.transpose(1, 2), k64, v64, is_causal=True), 8)
    b64, by64 = bound(2 * (2 * S * nh * 64 + 2 * nkv * S * 64),
                      4 * 64 * nh * S * (S + 1) / 2, "bf16", rate)
    print(f"  flash_attention hd=64 [S {S}, kv {S}, {nh} heads]: {ms64 * 1e3:.1f} us "
          f"(bound {b64 * 1e3:.2f} us, {by64}; sdpa causal {lib64 * 1e3:.1f} us): "
          f"{L * ms64:.5f} ms for {L} calls, sdpa {L * lib64:.5f}")
    del q64, k64, v64

    # flash_attention: one 512-token prefill (one call per layer).
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
    rows.append(dict(row=4, name="flash_attention",
                     source="metalchat_tpu_torch/csrc/flash_attention.cu",
                     replaces="metalchat_tpu/ops/flash_attention_pallas.py:136",
                     ms=L * ms, plain_ms=L * plain, library_ms=L * lib,
                     bound_ms=L * b_ms, bound_by=b_by,
                     unit=f"one {S}-token prefill ({L} calls)"))
    for r in rows:
        counter = r.get("counter", r["name"])
        r.setdefault("max_abs_err", sm.err.get(counter))
        r.update(route="cuda", launches=counts[counter])
    return rows


SERVE_ROWS = {"paged_decode_attention_update": 8, "paged_decode_attention_stacked": 9,
              "decode_attention": 5}


def time_a8_serve(sm: Smoke, cfg, params, one_row, counts, rate: float):
    """Rows 1 and 2 at the serve decode step's 8 rows, per matrix: the fused
    call (a8_quantize, then the tensor-core matvec), a8_quantize alone, the
    plain version, the bound, phase timing's yardstick (torch._int_mm at
    M=17 on unpacked int8 weights) and raw mode; then the step's totals at 2
    and 16 rows. ``one_row`` holds phase timing's rows 1 and 2 (one row, the
    generate path), which go into the unit."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import a8_matvec as am

    dev = torch.device("cuda")
    L, eps = cfg.num_layers, cfg.rms_norm_eps
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    steps = {}
    for rows in (8, 2, 16):
        step = dict.fromkeys(("ms", "quantize_ms", "bound_ms", "library_ms", "plain_ms",
                              "quantize_plain_ms", "quantize_bound_ms", "raw_ms",
                              "raw_plain_ms", "raw_bound_ms"), 0.0)
        for name, pq, ps, xin, norm, per_step in a8_calls(torch, cfg, params, rows, gen):
            n_layers, out_f, k = pq.shape
            in_f = 2 * k
            kw = dict(bits=4) if norm is None else dict(bits=4, norm_stack=norm, norm_eps=eps)
            qkw = {} if norm is None else dict(norm_eps=eps)
            nw = (lambda i: None) if norm is None else (lambda i: norm[i % n_layers])  # noqa: E731
            vals = dict(
                ms=sm.device_ms(lambda i: am.quant_matvec_stacked_fused(
                    xin, pq, ps, i % n_layers, **kw), 64),
                quantize_ms=sm.device_ms(lambda i: am.quantize_rows(xin, nw(i), **qkw), 64),
                bound_ms=a8_bound(pq, norm, rows, rate)[0], library_ms=sm.a8_library[name])
            if rows == 8:
                xq = torch.randint(-127, 128, (rows, in_f), generator=gen, device=dev,
                                   dtype=torch.int8)
                vals.update(
                    plain_ms=sm.eager_ms(lambda i: am.quant_matvec_stacked_fused_plain(
                        xin, pq, ps, i % n_layers, **kw), 3),
                    quantize_plain_ms=sm.eager_ms(
                        lambda i: am.quantize_rows_plain(xin, nw(i), **qkw), 3),
                    # x in, the norm weights, codes, sx and corr out
                    quantize_bound_ms=bound(rows * in_f * 3 + (0 if norm is None else 2 * in_f)
                                            + rows * 8, 0, "f32", rate)[0],
                    raw_ms=sm.device_ms(lambda i: am.quant_matvec_stacked(
                        xq, pq, i % n_layers, bits=4), 64),
                    raw_plain_ms=sm.eager_ms(lambda i: am.quant_matvec_stacked_plain(
                        xq, pq, i % n_layers, bits=4), 3),
                    raw_bound_ms=bound(out_f * k + rows * in_f + rows * out_f * 4,
                                       2 * rows * in_f * out_f, "int8", rate)[0])
                print(f"  a8_matvec {name} [{out_f}x{in_f} w4, {rows} rows]: "
                      f"{vals['ms'] * 1e3:.2f} us (a8_quantize alone "
                      f"{vals['quantize_ms'] * 1e3:.2f} us; bound {vals['bound_ms'] * 1e3:.2f} "
                      f"us, bytes; plain {vals['plain_ms'] * 1e3:.1f} us; _int_mm M=17 int8 "
                      f"{vals['library_ms'] * 1e3:.2f} us); raw mode {vals['raw_ms'] * 1e3:.2f} "
                      f"us (bound {vals['raw_bound_ms'] * 1e3:.2f} us) x{per_step}/step")
            for key, val in vals.items():
                step[key] += per_step * val
        steps[rows] = step
        print(f"  a8_matvec at {rows} rows, one serve decode step ({4 * L + 1} calls): "
              f"{step['ms']:.4f} ms, a8_quantize alone {step['quantize_ms']:.4f} ms (bound "
              f"{step['bound_ms']:.4f} ms, bytes; _int_mm M=17 {step['library_ms']:.4f} ms)")
    s8 = steps[8]
    at = {r: f"{steps[r]['ms']:.4f} ms (bound {steps[r]['bound_ms']:.4f})" for r in (2, 16)}

    def at_one(r):
        return (f"at 1 row (generate) {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, launches {r['launches']}")

    common = dict(source="metalchat_tpu_torch/csrc/a8_matvec.cu", route="cuda", bound_by="bytes")
    return [
        dict(common, row=1, name="a8_matvec", counter="a8_matvec",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262", ms=s8["ms"],
             plain_ms=s8["plain_ms"], bound_ms=s8["bound_ms"], library_ms=s8["library_ms"],
             max_abs_err=sm.err["a8_matvec"], launches=counts["a8_matvec"],
             unit=f"one serve decode step at 8 rows ({4 * L + 1} calls, each a8_quantize and "
                  f"the tensor-core matvec); 2 rows {at[2]}, 16 rows {at[16]}; "
                  + at_one(one_row[1])),
        dict(common, row=1, name="a8_quantize", counter="a8_quantize",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:262", ms=s8["quantize_ms"],
             plain_ms=s8["quantize_plain_ms"], bound_ms=s8["quantize_bound_ms"],
             library_ms=None, max_abs_err=sm.err["a8_quantize"], launches=counts["a8_quantize"],
             unit=f"the act-quant of row 1's {4 * L + 1} calls at 8 rows (inside row 1's "
                  "time); max_abs_err in int8 code quanta; library_ms null: no single "
                  "PyTorch call"),
        dict(common, row=2, name="a8_matvec_raw", counter="a8_matvec_raw",
             replaces="metalchat_tpu/ops/a8_matvec_pallas.py:187", ms=s8["raw_ms"],
             plain_ms=s8["raw_plain_ms"], bound_ms=s8["raw_bound_ms"],
             library_ms=s8["library_ms"], max_abs_err=0.0, launches=counts["a8_matvec_raw"],
             unit=f"one serve decode step's {4 * L + 1} shapes at 8 rows, int8 rows in, int32 "
                  "out (raw mode, on no driven path; library as row 1); " + at_one(one_row[2])),
    ]


def phase_timing_serve(sm: Smoke, main, serve, fixture_counts, one_row, rate: float):
    """The serve path's attention kernels at its shapes, one decode step
    (one call per layer) of 8 rows with lengths spread 128..1024. The paged
    kernel over the serve run's pool: write mode (row 8) and read-only on
    the stacked pool (row 9; row 7 is the same launch on a one-layer view).
    The dense kernel's read-only mode over a bf16 cache of 8 rows of 1024
    (row 5, the engine's default dense mode). Library yardstick: SDPA over
    the same K/V in bf16 (pages gathered and dequantized), heads repeated, a
    length mask. First the matvecs of one decode step (`time_a8_serve`)."""
    torch = sm.torch
    import torch.nn.functional as F

    from metalchat_tpu_torch.cache import dequantize_kv, gather_page_scales, gather_pages_dense
    from metalchat_tpu_torch.ops import decode_attention as dm
    from metalchat_tpu_torch.ops import paged_attention as pm

    cfg = main[0]
    engine = serve["paged"]["engine"]
    c = engine.cache
    dev = torch.device("cuda")
    L, nh, nkv, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, mp, psize = c.page_table.shape[0], c.page_table.shape[1], c.page_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lengths = [(i + 1) * mp * psize // B for i in range(B)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)
    q = torch.randn((B, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn = torch.randn((B, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pool = (c.k_pages, c.v_pages, c.k_scale, c.v_scale)
    scale = hd ** -0.5
    visited = sum(lengths)
    # Bytes: the visited K/V rows and their scales, q in, out, the table and
    # lengths; write mode adds the new rows in and their codes and scales out.
    read_bytes = (visited * nkv * 2 * (hd + 4) + 2 * B * nh * hd * 2 + B * mp * 4 + B * 4)
    write_bytes = 2 * B * nkv * hd * 2 + 2 * B * nkv * (hd + 4)
    ops = 4 * nh * hd * visited

    kd = dequantize_kv(gather_pages_dense(c.k_pages[0], table), gather_page_scales(c.k_scale[0], table))
    vd = dequantize_kv(gather_pages_dense(c.v_pages[0], table), gather_page_scales(c.v_scale[0], table))
    kd, vd = (t.repeat_interleave(nh // nkv, dim=1) for t in (kd, vd))
    mask = (torch.arange(mp * psize, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib = L * sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask), 32)
    del kd, vd

    # Row 5: a bf16 cache [L, 8, n_kv, 1024, hd] of random values; bytes of
    # the visited rows (2 bytes an element, no scales), q in and out.
    T = mp * psize
    kc, vc = (torch.randn((L, B, nkv, T, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    dense_bytes = visited * nkv * 2 * hd * 2 + 2 * B * nh * hd * 2 + B * 4
    kr, vr = (t[0].repeat_interleave(nh // nkv, dim=1) for t in (kc, vc))
    lib_dense = L * sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None, :], kr, vr, attn_mask=mask), 32)
    del kr, vr
    cases = [
        ("paged_decode_attention_update", "paged_decode_attention_update",
         "metalchat_tpu_torch/csrc/paged_attention.cu",
         "metalchat_tpu/ops/paged_attention_pallas.py:410", "write mode, paged",
         lambda i: pm.paged_decode_attention_update_stacked(
             q, kn, kn, *pool, table, lens, i % L, scale=scale),
         lambda i: pm.paged_decode_attention_update_plain(
             q, kn, kn, *pool, table, lens, i % L, scale=scale), read_bytes + write_bytes,
         lib, serve["paged"]["counts"]),
        ("paged_decode_attention_stacked", "paged_decode_attention",
         "metalchat_tpu_torch/csrc/paged_attention.cu",
         "metalchat_tpu/ops/paged_attention_pallas.py:491", "read-only, paged",
         lambda i: pm.paged_decode_attention_stacked(q, *pool, table, lens, i % L,
                                                     scale=scale),
         lambda i: pm.paged_decode_attention_plain(q, *pool, table, lens, i % L, scale=scale),
         read_bytes, lib, serve["paged"]["counts"]),
        ("decode_attention", "decode_attention",
         "metalchat_tpu_torch/csrc/decode_attention.cu",
         "metalchat_tpu/ops/decode_attention_pallas.py:323", "read-only, dense bf16 cache",
         lambda i: dm.decode_attention_stacked(q, kc, vc, i % L, lens, scale=scale),
         lambda i: dm.decode_attention_stacked_plain(q, kc, vc, None, None, i % L, lens,
                                                     scale=scale),
         dense_bytes, lib_dense, fixture_counts["dense-act"]),
    ]
    rows = time_a8_serve(sm, cfg, main[1], one_row, serve["paged"]["counts"], rate)
    for name, counter, source, replaces, mode, kernel, plain, nbytes, lib_ms, path in cases:
        ms = L * sm.device_ms(kernel, 64)
        plain_ms = L * sm.eager_ms(plain, 3)
        b_ms, b_by = bound(L * nbytes, L * ops, "f32", rate)
        print(f"  {name} [{mode}; 8 rows, lengths {lengths[0]}..{lengths[-1]}, T {T}]: "
              f"{ms:.4f} ms a step (bound {b_ms:.5f} ms, {b_by}; plain {plain_ms:.3f} ms; "
              f"sdpa bf16 {lib_ms:.4f} ms) for {L} calls")
        rows.append(dict(
            row=SERVE_ROWS[name], name=name, source=source, replaces=replaces, route="cuda",
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=sm.err[counter], launches=path[counter], counter=counter,
            unit=f"one decode step ({L} calls, 8 rows, lengths {lengths[0]}..{lengths[-1]})"))
    del kc, vc
    # Rows 6 and 7 are rows 5 and 9's launches on a one-layer view of the
    # cache: the same kernel and numbers; no driven path calls those wrappers.
    for row, name, like, replaces in (
            (6, "decode_attention_one_layer", "decode_attention",
             "metalchat_tpu/ops/decode_attention_pallas.py:229"),
            (7, "paged_decode_attention_one_layer", "paged_decode_attention_stacked",
             "metalchat_tpu/ops/paged_attention_pallas.py:167")):
        base = next(r for r in rows if r["name"] == like)
        rows.append(dict(base, row=row, name=name, replaces=replaces, launches=0,
                         counter=None, unit=f"as row {base['row']}: {base['unit']}; the "
                         "one-layer wrapper is on no driven path"))
    return rows


def phase_timing_int4(sm: Smoke, run, rate: float):
    """Row 11 at 8b-int4's decode step, at 1 row (the generate path) and at
    8 rows: the 129 calls of one step, kernel (CUDA graph replay), plain
    version (eager), and as the library yardstick one torch.matmul of x
    against the weights already dequantized to bf16 (it leaves out the
    dequantization). Bound: the packed weights, the group scales, x in and
    out once."""
    torch = sm.torch
    from metalchat_tpu_torch.ops import quant_matmul as qm

    cfg, params, counts = run[0], run[1], run[3]
    L = cfg.num_layers
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    layers, lm = params["layers"], params["lm_head"]
    steps = {}
    for rows in (1, 8):
        x = torch.randn((rows, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
        xf = torch.randn((rows, cfg.intermediate_size), generator=gen, device=dev).to(
            torch.bfloat16)
        step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for name, leaf, xin, per_step in (("wqkv", layers["wqkv"], x, L),
                                          ("wo", layers["wo"], x, L),
                                          ("w13", layers["w13"], x, L),
                                          ("w2", layers["w2"], xf, L), ("lm_head", lm, x, 1)):
            n = leaf.q.shape[0] if leaf.q.ndim == 3 else 1
            at = (lambda i: leaf.layer(i % n)) if leaf.q.ndim == 3 else (lambda i: leaf)
            kw = dict(bits=leaf.bits, group_size=leaf.group_size, transposed=leaf.transposed)
            ms = sm.device_ms(lambda i: qm.dequant_matmul(xin, at(i).q, at(i).scales, **kw), 64)
            plain = sm.eager_ms(lambda i: qm.dequant_matmul_plain(xin, at(i).q, at(i).scales,
                                                                  **kw), 3)
            one = at(0)
            n_lib = max(1, min(n, math.ceil(120e6 / (2 * one.in_features * one.out_features))))
            dense = [qm.dequant_weight(at(i).q, at(i).scales, dtype=torch.bfloat16, **kw)
                     for i in range(n_lib)]
            lib = sm.device_ms(lambda i: torch.matmul(xin, dense[i % n_lib]), 32)
            del dense
            nbytes = (one.q.numel() + one.scales.numel() * one.scales.element_size()
                      + 2 * rows * (one.in_features + one.out_features))
            b_ms, b_by = bound(nbytes, 2 * rows * one.in_features * one.out_features, "bf16",
                               rate)
            print(f"  quant_matmul {name} [{one.out_features}x{one.in_features} w{leaf.bits} "
                  f"g{leaf.group_size} {'transposed' if leaf.transposed else 'natural'}, "
                  f"{rows} row(s)]: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us, {b_by}; "
                  f"plain {plain * 1e3:.1f} us; matmul on bf16 weights {lib * 1e3:.2f} us) "
                  f"x{per_step}/token")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bound_ms", b_ms)):
                step[key] += per_step * val
        print(f"  quant_matmul at {rows} row(s), one 8b-int4 decode step ({4 * L + 1} calls): "
              f"{step['ms']:.4f} ms (bound {step['bound_ms']:.4f} ms; plain "
              f"{step['plain_ms']:.3f}; matmul on bf16 weights {step['library_ms']:.4f})")
        steps[rows] = step
    s8 = steps[8]
    return [dict(row=11, name="quant_matmul", source="metalchat_tpu_torch/csrc/quant_matmul.cu",
                 replaces="metalchat_tpu/ops/quant_matmul_pallas.py:145", route="cuda",
                 bound_by="bytes", launches=counts["quant_matmul"],
                 max_abs_err=sm.err["quant_matmul"],
                 unit=f"one 8b-int4 decode step ({4 * L + 1} calls, 1 row); library_ms is "
                      "torch.matmul on weights dequantized to bf16 beforehand; at 8 rows "
                      f"{s8['ms']:.4f} ms (bound {s8['bound_ms']:.4f}, plain "
                      f"{s8['plain_ms']:.3f}, library {s8['library_ms']:.4f})", **steps[1])]


def phase_timing_ffn(sm: Smoke, main, ffn_run, rate: float):
    """Row 10 at 8b-w4a8's decode step, 1 and 8 rows: the kernel (one
    cooperative launch a layer) and the unmerged route of the same step (3
    a8_matvec launches and the glue a layer), both by CUDA graph replay, the
    plain version (eager), and the bound: wo,
    w13 and w2 packed bytes and scales, the norm weights, rows in and out.
    No single PyTorch call computes the block: library_ms is null."""
    torch = sm.torch
    from metalchat_tpu_torch.models.transformer import silu_gate
    from metalchat_tpu_torch.ops import a8_matvec as am
    from metalchat_tpu_torch.ops import ffn_block as fb

    cfg, params = main[0], main[1]
    L, H = cfg.num_layers, cfg.hidden_size
    eps = cfg.rms_norm_eps
    lay = params["layers"]
    wo, w13, w2, nw = lay["wo"], lay["w13"], lay["w2"], lay["ffn_norm"]
    args = (wo.q, wo.scales, nw, w13.q, w13.scales, w2.q, w2.scales)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = []
    for rows in (1, 8):
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))

        def merged(i):
            return fb.ffn_block_stacked(attn, x, *args, i % L, bits=4, act="silu", eps=eps)

        def unmerged(i):
            l = i % L
            x2 = x + am.quant_matvec_stacked_fused(attn, wo.q, wo.scales, l, bits=4)
            g = silu_gate(am.quant_matvec_stacked_fused(x2, w13.q, w13.scales, l, bits=4,
                                                        norm_stack=nw, norm_eps=eps))
            return x2 + am.quant_matvec_stacked_fused(g, w2.q, w2.scales, l, bits=4)

        ms = L * sm.device_ms(merged, 64)
        unmerged_ms = L * sm.device_ms(unmerged, 64)
        plain = L * sm.eager_ms(lambda i: fb.ffn_block_plain(
            attn, x, *args, i % L, bits=4, act="silu", eps=eps), 3)
        nbytes = sum(t[0].numel() * t.element_size() for t in args) + 2 * 2 * rows * H
        ops = 2 * rows * (wo.q.shape[1] * wo.in_features + w13.q.shape[1] * w13.in_features
                          + w2.q.shape[1] * w2.in_features)
        b_ms, b_by = bound(L * nbytes, L * ops, "int8", rate)
        print(f"  ffn_block [{rows} row(s), H {H}, F {cfg.intermediate_size}, w4]: "
              f"{ms:.4f} ms a step (bound {b_ms:.4f} ms, {b_by}; unmerged route "
              f"{unmerged_ms:.4f} ms; plain {plain:.3f} ms) for {L} launches")
        if rows == 1:
            out.append(dict(row=10, name="ffn_block", source="metalchat_tpu_torch/csrc/ffn_block.cu",
                            replaces="metalchat_tpu/ops/ffn_block_pallas.py:271", route="cuda",
                            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None, unmerged_ms=unmerged_ms,
                            launches=ffn_run[3]["ffn_block"], max_abs_err=sm.err["ffn_block"],
                            unit=f"one 8b-w4a8 decode step ({L} launches, 1 row); "
                                 "library_ms null: no single PyTorch call computes the block"))
        else:
            out[0]["unit"] += (f"; at {rows} rows {ms:.4f} ms (bound {b_ms:.4f}, unmerged "
                               f"{unmerged_ms:.4f}, plain {plain:.3f})")
    return out



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
    ffn_run = int4_run = None
    smi = sm.phase("device", phase_device)
    dev_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {dev_name}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    if sm.phase("build", phase_build) is not None:
        sm.phase("kernels", lambda: phase_kernels(sm))
        sm.phase("fixture", lambda: phase_fixture(sm))
        sm.phase("fixture-int", lambda: phase_fixture_int(sm, FIXTURE_INT_DTYPE))
        main_run = sm.phase("main", lambda: phase_main(sm, dev_name))
        rows = None
        if main_run is not None:
            sm.phase("profile", lambda: phase_profile(sm, main_run))
            ffn_run = sm.phase("main-ffn-block",
                               lambda: phase_main_ffn_block(sm, main_run, dev_name))
        int4_run = sm.phase("main-int4", lambda: phase_main_int4(sm, dev_name))
        if int4_run is not None:
            sm.phase("profile-int4", lambda: phase_profile(sm, int4_run, "8b-int4"))
        fixture_counts = sm.phase("serve-fixture", lambda: phase_serve_fixture(sm))
        serve = None
        if main_run is not None:
            serve = sm.phase("serve", lambda: phase_serve(sm, main_run, hbm_rate(dev_name)))
        sm.phase("http", lambda: phase_http(sm))
        if main_run is not None:
            rows = sm.phase("timing", lambda: phase_timing(sm, main_run, hbm_rate(dev_name)))
        if serve is not None and fixture_counts is not None and rows is not None:
            # Rows 1 and 2 at one row move into the unit of their 8-row rows.
            one_row = {r["row"]: r for r in rows if r["row"] in (1, 2)}
            serve_rows = sm.phase("timing-serve", lambda: phase_timing_serve(
                sm, main_run, serve, fixture_counts, one_row, hbm_rate(dev_name)))
            rows = None if serve_rows is None else [
                r for r in rows if r["row"] not in one_row] + serve_rows
        if rows is not None and ffn_run is not None:
            more = sm.phase("timing-ffn", lambda: phase_timing_ffn(
                sm, main_run, ffn_run, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
        if rows is not None and int4_run is not None:
            more = sm.phase("timing-int4", lambda: phase_timing_int4(
                sm, int4_run, hbm_rate(dev_name)))
            rows = None if more is None else rows + more
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    if sm.failures or not smi or rows is None:
        print(f"chip_smoke: FAILED phases: {sm.failures}", file=sys.stderr)
        return 1
    by_path = {"generate 8b-w4a8": main_run[3], "generate 8b-w4a8 ffn_block": ffn_run[3],
               "generate 8b-int4": int4_run[3], "serve paged": serve["paged"]["counts"],
               "serve dense": serve["dense"]["counts"],
               "serve-fixture dense-act": fixture_counts["dense-act"]}
    for r in rows:
        counter = r.get("counter", r["name"])
        r["launches_by_path"] = {path: c[counter] if counter else 0
                                 for path, c in by_path.items()}
    rows.sort(key=lambda r: r["row"])
    keys = ("row", "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "unit", "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
