"""Row 1 at one row (the W4A8 matvec, fused and raw) and row 10 (the merged
FFN block) from two versions of their sources, timed in turns within one
call.

Builds ``a8_matvec.cu`` and ``ffn_block.cu`` of another version's ``csrc``
directory (``--baseline DIR``, holding those files and their headers) beside
the repository's, one ``nvcc`` each, all at once, into
``metalchat_tpu_torch/build/matvec_ffn_turns/``. At Llama-3.1-8B widths
(int4, bf16 activations and scales, random weights from a seeded generator,
enough layers of each matrix to pass the 50 MB L2 cache), by CUDA graph
replay, in the order baseline, repo, repo, baseline:

  row 1   one decode step's 129 fused calls at one row (wqkv and w13 with the
          norm prologue, wo, w2, lm_head), each matrix's µs a call;
  row 2   raw mode at the same shapes;
  row 10  one decode step of 32 launches at 1 and 8 rows (silu), and the
          unmerged route of the same step (three matvec calls and the glue a
          layer) through the same version's matvec.

The baseline's library is swapped into the matvec wrapper for
``quantize_rows`` and raw mode at 2-16 rows, whose C signatures are the
repository's; its fused calls (``a8_matvec_fused`` at one row, ``a8_mma``
after ``quantize_rows`` at 2-16), its raw calls at one row and its
``ffn_block`` are called with PR 7's signatures. Each
version's outputs are held once against the plain version (``chip_smoke``'s
limits; row 10 phases A and C, from the kernel's own x2 and h).

``--variant DIR`` (a directory holding another ``ffn_block.cu`` and its
headers, whose C entry takes the repository's arguments) adds that build's
row 10 at one row to the repository's turns, checked as the others. Run on
a machine with an H100 from the repository root, for example against PR 7's
tree:

    git archive 99a6263 metalchat_tpu_torch/csrc | tar -x -C archive/pr7
    python3 experiments/matvec_ffn_turns.py --baseline archive/pr7/metalchat_tpu_torch/csrc
"""

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.models.transformer import act_gate  # noqa: E402
from metalchat_tpu_torch.ops import _build  # noqa: E402
from metalchat_tpu_torch.ops import a8_matvec as am  # noqa: E402
from metalchat_tpu_torch.ops import ffn_block as fb  # noqa: E402

SOURCES = ("a8_matvec", "ffn_block")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(csrc: Path, out: Path, variant: Path = None) -> dict:
    """{"repo": {source: CDLL}, "baseline": {source: CDLL}, "variant":
    {"ffn_block": CDLL} or {}}."""
    if out.exists():
        shutil.rmtree(out)
    procs = {}
    jobs = [("baseline", csrc, name) for name in SOURCES]
    jobs += [("variant", variant, "ffn_block")] if variant else []
    for label, src, name in jobs:
        (out / label).mkdir(parents=True, exist_ok=True)
        for f in src.glob("*.cuh"):
            shutil.copy(f, out / label / f.name)
        shutil.copy(src / f"{name}.cu", out / label / f"{name}.cu")
        procs[label, name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / label / f"lib{name}.so"),
             str(out / label / f"{name}.cu")], stdout=open(out / label / f"{name}.log", "w"),
            stderr=subprocess.STDOUT)
    _build.build_all(SOURCES)
    libs = {"repo": {"a8_matvec": am._lib(), "ffn_block": fb._lib()}, "baseline": {},
            "variant": {}}
    for (label, name), proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError((out / label / f"{name}.log").read_text()[-3000:])
        libs[label][name] = ctypes.CDLL(str(out / label / f"lib{name}.so"))
    if variant:
        libs["variant"]["ffn_block"].ffn_block.argtypes = fb._lib().ffn_block.argtypes
        libs["variant"]["ffn_block"].ffn_block.restype = I
    base = libs["baseline"]
    for entry in ("a8_quantize", "a8_mma_raw"):
        fn = getattr(base["a8_matvec"], entry)
        fn.argtypes, fn.restype = getattr(libs["repo"]["a8_matvec"], entry).argtypes, I
    base["a8_matvec"].a8_mma.argtypes = [P] * 6 + [I] * 6 + [P]
    base["a8_matvec"].a8_mma.restype = I
    base["a8_matvec"].a8_matvec_fused.argtypes = [P] * 5 + [I] * 6 + [F, F, P]
    base["a8_matvec"].a8_matvec_raw.argtypes = [P] * 3 + [I] * 4 + [P]
    for entry in ("a8_matvec_fused", "a8_matvec_raw"):
        getattr(base["a8_matvec"], entry).restype = I
    base["ffn_block"].ffn_block.argtypes = [P] * 12 + [I] * 7 + [F, F, P]
    base["ffn_block"].ffn_block.restype = I
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="the other version's csrc directory")
    ap.add_argument("--variant", help="a directory with a variant ffn_block.cu (see above)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matvec_ffn_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    libs = build(Path(args.baseline).resolve(), _build.BUILD_DIR / "matvec_ffn_turns",
                 Path(args.variant).resolve() if args.variant else None)
    repo_a8 = am._lib
    sm = cs.Smoke(torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    L, H, Fi, eps = 32, 4096, 14336, 1e-5

    mats = []  # row 1: (name, packed [n, out, k], scales, norm or None, x [1, in], xq, per step)
    for name, out_f, in_f, bits, norm in cs.A8_8B:
        k = in_f // 2
        n = max(1, min(8, math.ceil(120e6 / (out_f * k))))
        mats.append((name, torch.randint(-128, 128, (n, out_f, k), generator=gen, device=dev,
                                         dtype=torch.int8),
                     (torch.rand((n, 1, out_f), generator=gen, device=dev) * 1e-3).to(
                         torch.bfloat16),
                     (torch.rand((n, in_f), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
                     if norm else None,
                     torch.randn((1, in_f), generator=gen, device=dev).to(torch.bfloat16),
                     torch.randint(-127, 128, (1, in_f), generator=gen, device=dev,
                                   dtype=torch.int8), 1 if name == "lm_head" else L))
    w = cs.ffn_weights(torch, L, H, Fi, 4, gen, dev, torch.bfloat16)
    args10 = tuple(w.values())
    rows10 = {r: tuple(torch.randn((r, H), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(2)) for r in (1, 8)}
    ffn_ws = {r: torch.empty(3 * r * Fi + 24 * r, dtype=torch.int8, device=dev) for r in (1, 8)}

    def ffn_call(version, attn, x, l):
        """One launch of the version's ffn_block kernel on layer l: out, x2, h."""
        if version == "repo":
            scratch = {}
            out = fb.ffn_block_stacked(attn, x, *args10, l, bits=4, act="silu", eps=eps,
                                       scratch=scratch)
            return out, scratch["x2"], scratch["h"]
        rows = x.shape[0]
        x2, h = torch.empty_like(x), torch.empty((rows, Fi), dtype=x.dtype, device=dev)
        out = torch.empty_like(x)
        ptrs = (attn.data_ptr(), x.data_ptr(), w["wo_q"][l].data_ptr(), w["wo_s"][l].data_ptr(),
                w["norm_w"][l].data_ptr(), w["w13_q"][l].data_ptr(), w["w13_s"][l].data_ptr(),
                w["w2_q"][l].data_ptr(), w["w2_s"][l].data_ptr(), x2.data_ptr(), h.data_ptr(),
                out.data_ptr())
        if version == "baseline":
            rc = libs["baseline"]["ffn_block"].ffn_block(
                *ptrs, rows, H, Fi, 4, 0, 1, 1, eps, 0.0, _build.stream_ptr(x))
        else:
            ws = ffn_ws[rows]  # codes [3][rows][Fi], sx and corr [3][rows]
            n = 3 * rows * Fi
            rc = libs["variant"]["ffn_block"].ffn_block(
                *ptrs, ws.data_ptr(), ws.data_ptr() + n, ws.data_ptr() + n + 12 * rows, rows, H,
                Fi, 4, 0, 1, 1, eps, 0.0, _build.stream_ptr(x))
        assert rc == 0, rc
        return out, x2, h

    def check_ffn(version, rows):
        attn, x = rows10[rows]
        out, x2, h = ffn_call(version, attn, x, 0)
        what = f"{version} ffn_block {rows} row(s)"
        sm.close("ffn_block", x2, fb.wo_stage(attn, x, w["wo_q"][0], w["wo_s"][0], bits=4),
                 what + " phase A (x2)")
        sm.close("ffn_block", out, fb.w2_stage(h, x2, w["w2_q"][0], w["w2_s"][0], bits=4)[0],
                 what + " phase C (out)")

    def fused(version, x, p, s, l, nw=None):
        """The version's fused matvec on layer l of p (PR 7's C entries)."""
        if version == "repo":
            kw = {} if nw is None else dict(norm_stack=nw, norm_eps=eps)
            return am.quant_matvec_stacked_fused(x, p, s, l, bits=4, **kw)
        rows, base = x.shape[0], libs["baseline"]["a8_matvec"]
        out = torch.empty((rows, p.shape[1]), dtype=x.dtype, device=dev)
        if rows == 1:
            rc = base.a8_matvec_fused(
                x.data_ptr(), p[l].data_ptr(), s[l].data_ptr(),
                None if nw is None else nw[l].data_ptr(), out.data_ptr(), 1, x.shape[1],
                p.shape[1], 4, 1, 1, eps, 0.0, _build.stream_ptr(x))
        else:
            xq, sx, corr = am.quantize_rows(x, None if nw is None else nw[l],
                                            None if nw is None else eps)
            rc = base.a8_mma(xq.data_ptr(), p[l].data_ptr(), s[l].data_ptr(), sx.data_ptr(),
                             corr.data_ptr(), out.data_ptr(), rows, x.shape[1], p.shape[1], 4,
                             1, 1, _build.stream_ptr(x))
        assert rc == 0, rc
        return out

    def raw(version, xq, p, l):
        """The version's raw-mode matvec on layer l of p (PR 7's signature at one row)."""
        if version == "repo" or xq.shape[0] > 1:
            return am.quant_matvec_stacked(xq, p, l, bits=4)
        out = torch.empty((1, p.shape[1]), dtype=torch.int32, device=dev)
        rc = libs["baseline"]["a8_matvec"].a8_matvec_raw(
            xq.data_ptr(), p[l].data_ptr(), out.data_ptr(), 1, xq.shape[1], p.shape[1], 4,
            _build.stream_ptr(xq))
        assert rc == 0, rc
        return out

    def unmerged(version, attn, x, l):
        x2 = x + fused(version, attn, w["wo_q"], w["wo_s"], l)
        g = act_gate(fused(version, x2, w["w13_q"], w["w13_s"], l, w["norm_w"]))
        return x2 + fused(version, g, w["w2_q"], w["w2_s"], l)

    for version in ("baseline", "repo", "repo", "baseline"):
        am._lib = repo_a8 if version == "repo" else (lambda: libs["baseline"]["a8_matvec"])
        one, raw_ms = {}, {}
        for name, p, s, nw, x1, xq, per in mats:
            n = p.shape[0]
            kw = dict(bits=4, norm_stack=nw, norm_eps=eps) if nw is not None else dict(bits=4)
            sm.close("a8_matvec", fused(version, x1, p, s, 0, nw),
                     am.quant_matvec_stacked_fused_plain(x1, p, s, 0, **kw),
                     f"{version} a8_matvec {name} one row", loose=nw is not None)
            sm.exact(raw(version, xq, p, 0), am.quant_matvec_stacked_plain(xq, p, 0, bits=4),
                     f"{version} a8_matvec raw {name} one row")
            one[name] = sm.device_ms(lambda i: fused(version, x1, p, s, i % n, nw), 64)
            raw_ms[name] = sm.device_ms(lambda i: raw(version, xq, p, i % n), 64)
        per = {m[0]: m[-1] for m in mats}
        print(f"{version}: row 1 one row {sum(per[k] * v for k, v in one.items()):.4f} ms "
              f"a step (" + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in one.items())
              + f" us); row 2 one row {sum(per[k] * v for k, v in raw_ms.items()):.4f} ms (" +
              ", ".join(f"{k} {v * 1e3:.2f}" for k, v in raw_ms.items()) + " us)", flush=True)
        for rows in (1, 8):
            check_ffn(version, rows)
            attn, x = rows10[rows]
            merged = L * sm.device_ms(lambda i: ffn_call(version, attn, x, i % L), 64)
            route = L * sm.device_ms(lambda i: unmerged(version, attn, x, i % L), 64)
            extra = ""
            if version == "repo" and rows == 1 and libs["variant"]:
                check_ffn("variant", rows)
                other = L * sm.device_ms(lambda i: ffn_call("variant", attn, x, i % L), 64)
                extra = f"; variant {other:.4f}"
            print(f"{version}: row 10 at {rows} row(s) {merged:.4f} ms a step (unmerged route "
                  f"{route:.4f}{extra})", flush=True)
    am._lib = repo_a8
    print("worst shares of the limit " + ", ".join(
        f"{k} {v:.3f}" for k, v in sm.share.items() if v), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
