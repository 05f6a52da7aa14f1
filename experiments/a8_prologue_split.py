"""Where the one-row-at-a-time matvec spent its time, at 8 rows and at one.

Before the 2-16 row route (``a8_quantize`` and the int8 tensor-core
matvec), every row count went through ``a8_matvec_kernel``: each block
quantized all B activation rows into shared memory (its prologue), then each
warp dotted whole weight rows against them. Its B <= 16 and B = 1
instances are rebuilt here, in three variants, each from an edited copy of
the source:

  a  as it is;
  b  the prologue only (the dot loop skipped, one store a block keeps the
     prologue's results alive);
  c  the dot loop only (the prologue skipped, the codes zero-filled).

Each is timed at the Llama-3.1-8B decode shapes (wqkv and w13 with the norm
prologue, wo, w2, lm_head; int4, bf16) at 8 rows and at one row by CUDA
graph replay, and summed over one decode step's 129 calls. Beside them, at
one row, the two-launch route of 2-16 rows (``a8_quantize``, then the
tensor-core matvec with one live code row; its B >= 2 gate lifted in the
copy): "two@1".

``a8_matvec_kernel`` is the kernel of the sources up to the one-row
redesign; point ``--csrc`` at such a version's ``csrc`` directory, for
example ``git archive 99a6263 metalchat_tpu_torch/csrc | tar -x -C
archive/pr7``. Run on a machine with an H100, from the repository root:
``python3 experiments/a8_prologue_split.py --csrc
archive/pr7/metalchat_tpu_torch/csrc``. The builds go to
``metalchat_tpu_torch/build/a8_split/``.
"""

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from metalchat_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_DIR / "a8_split"

A1 = "  for (int b = 0; b < B; ++b) {\n    int8_t* row = xq"
A2 = "  }\n  __syncthreads();\n\n  const int lane = threadIdx.x & 31;"
A3 = "  for (int o = blockIdx.x * kWarps + warp; o < out_f; o += gridDim.x * kWarps) {"
ZERO = """#ifdef SKIP_PROLOGUE
  for (int i = threadIdx.x; i < B * in_f / 16; i += blockDim.x)
    reinterpret_cast<int4*>(xq)[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < B) { sx[threadIdx.x] = 1.f; corr[threadIdx.x] = 0; }
#else
"""
SINK = """#ifdef SKIP_DOT
  if (threadIdx.x == 0 && MODE != kRaw)
    static_cast<T*>(out_)[blockIdx.x % out_f] =
        from_f32<T>(sx[B - 1] + (float)corr[0] + (float)xq[(size_t)B * in_f - 1]);
  return;
#endif
"""
# The mma route's row gate, lifted so that one row can take it.
GATE = "if (B < 2 || B > 16) return (int)cudaErrorInvalidValue;"
# The instance that served 2-16 rows: launch<16, ...> (16 rows of shared
# memory, opted in above 48 KiB); the one-row instance, launch<1, ...>; and
# the two-launch route.
ENTRY = """
extern "C" int a8_split_fused(const void* x, const void* p, const void* s, const void* nw,
                              void* out, int B, int in_f, int out_f, float eps, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nw)
    return launch<16, 4, kFusedNorm, __nv_bfloat16, __nv_bfloat16>(x, w, s, nw, out, B, in_f,
                                                                   out_f, eps, 0.f, st);
  return launch<16, 4, kFused, __nv_bfloat16, __nv_bfloat16>(x, w, s, nw, out, B, in_f, out_f,
                                                             eps, 0.f, st);
}

extern "C" int a8_split_fused1(const void* x, const void* p, const void* s, const void* nw,
                               void* out, int B, int in_f, int out_f, float eps, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nw)
    return launch<1, 4, kFusedNorm, __nv_bfloat16, __nv_bfloat16>(x, w, s, nw, out, B, in_f,
                                                                  out_f, eps, 0.f, st);
  return launch<1, 4, kFused, __nv_bfloat16, __nv_bfloat16>(x, w, s, nw, out, B, in_f, out_f,
                                                            eps, 0.f, st);
}

extern "C" int a8_split_two(const void* x, const void* p, const void* s, const void* nw,
                            void* xq, void* sx, void* corr, void* out, int B, int in_f,
                            int out_f, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = quantize<__nv_bfloat16>(nw != nullptr, x, nw, static_cast<int8_t*>(xq),
                                   static_cast<float*>(sx), static_cast<int*>(corr), B, in_f,
                                   eps, 0.f, st);
  if (rc) return rc;
  return launch_mma<4, kFused, __nv_bfloat16, __nv_bfloat16>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(p), s,
      static_cast<const float*>(sx), static_cast<const int*>(corr), out, B, in_f, out_f, st);
}
"""


def build(csrc, name, define):
    text = (csrc / "a8_matvec.cu").read_text()
    for a in (A1, A2, A3, GATE):
        if text.count(a) != 1:
            raise SystemExit(f"{csrc / 'a8_matvec.cu'} has no a8_matvec_kernel to split "
                             f"(anchor {a!r}): point --csrc at a version that has one")
    text = text.replace(A1, ZERO + A1).replace(A2, "  }\n#endif" + A2[3:])
    text = text.replace(A3, SINK + A3).replace(GATE, GATE.replace("B < 2", "B < 1")) + ENTRY
    src = OUT / f"{name}.cu"
    src.write_text((f"#define {define}\n" if define else "") + text)
    lib = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib), str(src)]
    log = open(OUT / f"{name}.log", "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC,
                    help="the csrc directory whose a8_matvec_kernel is split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("a8_prologue_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {v: build(args.csrc.resolve(), v, d)
             for v, d in (("a", None), ("b", "SKIP_DOT"), ("c", "SKIP_PROLOGUE"))}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for v, (proc, path) in procs.items():
        if proc.wait():
            print((OUT / f"{v}.log").read_text()[-3000:], file=sys.stderr)
            return 1
        libs[v] = ctypes.CDLL(str(path))
        for entry in ("a8_split_fused", "a8_split_fused1"):
            getattr(libs[v], entry).argtypes = [P, P, P, P, P, I, I, I, F, P]
            getattr(libs[v], entry).restype = I
    libs["a"].a8_split_two.argtypes = [P, P, P, P, P, P, P, P, I, I, I, F, P]
    libs["a"].a8_split_two.restype = I
    from metalchat_tpu_torch.ops import a8_matvec as am

    torch.set_grad_enabled(False)
    sm = chip_smoke.Smoke(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    totals = {}
    for name, out_f, in_f, bits, norm in chip_smoke.A8_8B:
        per_step = 1 if name == "lm_head" else 32
        k = in_f // 2
        n = max(1, min(8, math.ceil(120e6 / (out_f * k))))  # layers enough to pass L2
        p = torch.randint(-128, 128, (n, out_f, k), generator=gen, device=dev, dtype=torch.int8)
        s = (torch.rand((n, 1, out_f), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
        nw = (torch.rand((n, in_f), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        x8 = torch.randn((8, in_f), generator=gen, device=dev).to(torch.bfloat16)
        y8 = torch.empty((8, out_f), dtype=torch.bfloat16, device=dev)
        x1 = x8[:1].contiguous()
        y1 = y8[:1].contiguous()
        xq1 = torch.empty((1, in_f), dtype=torch.int8, device=dev)
        sx1 = torch.empty(1, dtype=torch.float32, device=dev)
        corr1 = torch.empty(1, dtype=torch.int32, device=dev)
        kw = dict(bits=bits, norm_stack=nw, norm_eps=1e-5) if norm else dict(bits=bits)

        def fused(lib, entry, x, y, rows, l):
            rc = getattr(lib, entry)(x.data_ptr(), p[l].data_ptr(), s[l].data_ptr(),
                                     nw[l].data_ptr() if norm else None, y.data_ptr(), rows,
                                     in_f, out_f, 1e-5, _build.stream_ptr(x))
            assert rc == 0, rc

        def two(l):
            rc = libs["a"].a8_split_two(x1.data_ptr(), p[l].data_ptr(), s[l].data_ptr(),
                                        nw[l].data_ptr() if norm else None, xq1.data_ptr(),
                                        sx1.data_ptr(), corr1.data_ptr(), y1.data_ptr(), 1,
                                        in_f, out_f, 1e-5, _build.stream_ptr(x1))
            assert rc == 0, rc

        # "a" (both instances) and the two-launch route compute the matvec:
        # each must agree with the plain version.
        for label, run, x, y in (("8 rows", lambda: fused(libs["a"], "a8_split_fused", x8, y8,
                                                            8, 0), x8, y8),
                                 ("one row", lambda: fused(libs["a"], "a8_split_fused1", x1,
                                                           y1, 1, 0), x1, y1),
                                 ("one row, two launches", lambda: two(0), x1, y1)):
            run()
            sm.close("a8_matvec", y, am.quant_matvec_stacked_fused_plain(x, p, s, 0, **kw),
                     f"{name} at {label}", loose=norm)
        times = {}
        for v, lib in libs.items():
            times[f"{v}@8"] = sm.device_ms(
                lambda i, lib=lib: fused(lib, "a8_split_fused", x8, y8, 8, i % n), 32)
            times[f"{v}@1"] = sm.device_ms(
                lambda i, lib=lib: fused(lib, "a8_split_fused1", x1, y1, 1, i % n), 32)
        times["two@1"] = sm.device_ms(lambda i: two(i % n), 32)
        for key, ms in times.items():
            totals[key] = totals.get(key, 0.0) + per_step * ms
        print(f"{name} [{out_f}x{in_f} w{bits}{' norm' if norm else ''}] x{per_step}: "
              + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in times.items()), flush=True)
        del p
    print("one decode step (129 calls): " + ", ".join(
        f"{key} {ms:.4f} ms" for key, ms in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
