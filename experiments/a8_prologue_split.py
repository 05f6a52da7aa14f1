"""Where the one-row-at-a-time matvec spent its time at 8 rows.

Before the 2-16 row route (``a8_quantize`` and the int8 tensor-core
matvec), every row count went through ``a8_matvec_kernel``: each block
quantized all B activation rows into shared memory (its prologue), then each
warp dotted whole weight rows against them. That kernel is still in
``metalchat_tpu_torch/csrc/a8_matvec.cu`` for one row; its B <= 16 instance
is rebuilt here, in three variants, each from an edited copy of the source:

  a  as it is;
  b  the prologue only (the dot loop skipped, one store a block keeps the
     prologue's results alive);
  c  the dot loop only (the prologue skipped, the codes zero-filled).

Each is timed at the Llama-3.1-8B decode shapes (wqkv and w13 with the norm
prologue, wo, w2, lm_head; int4, bf16) at 8 rows by CUDA graph replay, and
summed over one decode step's 129 calls; "a" also at one row, through the
repo's own instance. Run on a machine with an H100, from the repository
root: ``python3 experiments/a8_prologue_split.py``. The builds go to
``metalchat_tpu_torch/build/a8_split/``.
"""

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
# The instance that served 2-16 rows: launch<16, ...> (16 rows of shared
# memory, opted in above 48 KiB).
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
"""


def build(name, define):
    text = (_build.CSRC / "a8_matvec.cu").read_text()
    for a in (A1, A2, A3):
        assert text.count(a) == 1, a
    text = text.replace(A1, ZERO + A1).replace(A2, "  }\n#endif" + A2[3:])
    text = text.replace(A3, SINK + A3) + ENTRY
    src = OUT / f"{name}.cu"
    src.write_text((f"#define {define}\n" if define else "") + text)
    lib = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib), str(src)]
    log = open(OUT / f"{name}.log", "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), lib


def main() -> int:
    if not torch.cuda.is_available():
        print("a8_prologue_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {v: build(v, d) for v, d in (("a", None), ("b", "SKIP_DOT"), ("c", "SKIP_PROLOGUE"))}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for v, (proc, path) in procs.items():
        if proc.wait():
            print((OUT / f"{v}.log").read_text()[-3000:], file=sys.stderr)
            return 1
        libs[v] = ctypes.CDLL(str(path))
        libs[v].a8_split_fused.argtypes = [P, P, P, P, P, I, I, I, F, P]
        libs[v].a8_split_fused.restype = I
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
        kw = dict(bits=bits, norm_stack=nw, norm_eps=1e-5) if norm else dict(bits=bits)
        # "a" is the kernel the repo ran at 8 rows: it must agree with the plain version.
        assert libs["a"].a8_split_fused(x8.data_ptr(), p[0].data_ptr(), s[0].data_ptr(),
                                        nw[0].data_ptr() if norm else None, y8.data_ptr(), 8,
                                        in_f, out_f, 1e-5, _build.stream_ptr(x8)) == 0
        sm.close("a8_matvec", y8, am.quant_matvec_stacked_fused_plain(x8, p, s, 0, **kw),
                 f"{name} at 8 rows", loose=norm)
        times = {}
        for v, lib in libs.items():
            def call(i, lib=lib):
                l = i % n
                rc = lib.a8_split_fused(x8.data_ptr(), p[l].data_ptr(), s[l].data_ptr(),
                                        nw[l].data_ptr() if norm else None, y8.data_ptr(), 8,
                                        in_f, out_f, 1e-5, _build.stream_ptr(x8))
                assert rc == 0, rc

            times[f"{v}@8"] = sm.device_ms(call, 32)
        times["a@1"] = sm.device_ms(lambda i: am.quant_matvec_stacked_fused(
            x1, p, s, i % n, **kw), 32)
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
