"""Row 11's design choices, timed in turns within one call.

Builds edited copies of ``metalchat_tpu_torch/csrc/quant_matmul.cu`` (each
with ``common.cuh``, one ``nvcc`` each, all at once) into
``metalchat_tpu_torch/build/qmm_variants/`` and times one 8b-int4 decode
step's 129 calls (wqkv, wo, w13, w2 a layer for 32 layers, and lm_head;
int4, group 32, bf16, random weights) by CUDA graph replay, at 1 and 8
rows, through the repo's wrapper with its library swapped:

  repo     the source as it is (transposed: 2 steps of loads in flight a
           warp and 3 blocks an SM);
  t_u4_b2  the transposed tensor-core kernel with 4 steps in flight and 2
           blocks an SM;
  nat8_b2  the non-transposed kernel at 2-8 rows compiled for 2 resident
           blocks an SM (registers capped) instead of 1.

Then the non-transposed kernel's split over k (``natural_plan``), wo and w2
over 32 distinct layers at 1 and 8 rows: the committed ``NAT_MIN_ROWS`` and
``NAT_BLOCKS_PER_SM`` first and last, other plans between.

Each output is checked once against the plain version. Run on a machine
with an H100, from the repository root:
``python3 experiments/qmm_variants.py``.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.ops import _build  # noqa: E402
from metalchat_tpu_torch.ops import quant_matmul as qm  # noqa: E402

SOURCE_EDITS = {
    "repo": [],
    "t_u4_b2": [("constexpr int kU = NT == 1 ? 2 : 1;", "constexpr int kU = NT == 1 ? 4 : 1;"),
                ("__launch_bounds__(kThreads, NT == 1 ? 3 : 1)",
                 "__launch_bounds__(kThreads, NT == 1 ? 2 : 1)")],
    "nat8_b2": [("__launch_bounds__(kThreads, MAXB == 1 ? 2 : 1)",
                 "__launch_bounds__(kThreads, MAXB == 32 ? 1 : 2)")],
}


def build(out: Path) -> dict:
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    procs = {}
    for name, edits in SOURCE_EDITS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"{name}: {a!r} not in the source")
            text = text.replace(a, b)
        (d / "quant_matmul.cu").write_text(text)
        (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "quant_matmul.cu")], stdout=open(d / "log", "w"), stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError((out / name / "log").read_text()[-3000:])
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.quant_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.quant_matmul.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("qmm_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    libs = build(_build.BUILD_DIR / "qmm_variants")
    sm = cs.Smoke(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    mats = {}
    for name, out_f, in_f, bits, g, tr in cs.QMM_8B_INT4:
        n = 4 if name != "lm_head" else 1
        mats[name] = (
            [torch.randint(-128, 128, (out_f, in_f // 2) if tr else (in_f // 2, out_f),
                           generator=gen, device=dev, dtype=torch.int8) for _ in range(n)],
            [(torch.rand((out_f, in_f // g) if tr else (in_f // g, out_f), generator=gen,
                         device=dev) * 0.01 + 0.001).to(torch.bfloat16) for _ in range(n)],
            in_f, g, tr)

    def step(lib, rows):
        qm._lib = lambda: libs[lib]
        per = {}
        for name, (qs, ss, in_f, g, tr) in mats.items():
            x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
            kw = dict(bits=4, group_size=g, transposed=tr)
            sm.close("quant_matmul", qm.dequant_matmul(x, qs[0], ss[0], **kw),
                     qm.dequant_matmul_plain(x, qs[0], ss[0], **kw), f"{lib} {name}")
            per[name] = sm.device_ms(lambda i: qm.dequant_matmul(
                x, qs[i % len(qs)], ss[i % len(ss)], **kw), 64)
        total = sum(v * (1 if n == "lm_head" else 32) for n, v in per.items())
        return total, per

    for label, rows in (("repo", 1), ("t_u4_b2", 1), ("repo", 1), ("repo", 8), ("t_u4_b2", 8),
                        ("nat8_b2", 8), ("repo", 8)):
        total, per = step(label, rows)
        print(f"{label} at {rows} row(s): {total:.4f} ms a step; per call us "
              + ", ".join(f"{n} {v * 1e3:.2f}" for n, v in per.items()), flush=True)
    qm._lib = lambda: libs["repo"]

    # The split over k: wo and w2 of 32 distinct layers (a step's weights do
    # not sit in L2), each plan as (least packed rows a block, blocks an SM).
    natural = {}
    for name, out_f, in_f in (("wo", 4096, 4096), ("w2", 4096, 14336)):
        natural[name] = (
            [torch.randint(-128, 128, (in_f // 2, out_f), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(32)],
            [(torch.rand((in_f // 32, out_f), generator=gen, device=dev) * 0.01 + 0.001)
             .to(torch.bfloat16) for _ in range(32)], in_f)
    base = (dict(qm.NAT_MIN_ROWS), dict(qm.NAT_BLOCKS_PER_SM))
    for rows, maxb in ((1, 1), (8, 8)):
        committed = (base[0][maxb], base[1][maxb])
        plans = [committed, (committed[0] // 2, committed[1]), (committed[0] * 2, committed[1]),
                 *((committed[0], b) for b in (2, 3, 4, 6, 8) if b != committed[1]), committed]
        for min_rows, blocks in plans:
            qm.NAT_MIN_ROWS = {**base[0], maxb: min_rows}
            qm.NAT_BLOCKS_PER_SM = {**base[1], maxb: blocks}
            qm.natural_plan.cache_clear()
            try:
                res = {}
                for name, (qs, ss, in_f) in natural.items():
                    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
                    kw = dict(bits=4, group_size=32, transposed=False)
                    sm.close("quant_matmul", qm.dequant_matmul(x, qs[0], ss[0], **kw),
                             qm.dequant_matmul_plain(x, qs[0], ss[0], **kw), name)
                    res[name] = sm.device_ms(
                        lambda i: qm.dequant_matmul(x, qs[i % 32], ss[i % 32], **kw), 64)
            finally:
                qm.NAT_MIN_ROWS, qm.NAT_BLOCKS_PER_SM = base
                qm.natural_plan.cache_clear()
            print(f"plan at {rows} row(s), at least {min_rows} packed rows a block, "
                  f"{blocks} blocks an SM: " + ", ".join(f"{n} {v * 1e3:.2f} us"
                                                        for n, v in res.items())
                  + f"; 32 layers {32 * sum(res.values()):.4f} ms", flush=True)
    print(f"worst share of the check's limit {sm.share['quant_matmul']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
