"""Where the merged FFN block (row 10, one cooperative launch a layer) spends
its time, at one row and at 8.

The kernel ``ffn_block_kernel`` of the sources up to its redesign runs three
phases (wo, w13, w2), each after a prologue in which every block quantizes
the phase's whole input (attn, the normed x2, h) itself, with a grid-wide
sync between phases. It is rebuilt here in four forms, each from an edited
copy of the source:

  a  as it is;
  b  the prologues only (every phase's dot loop skipped; a store no run
     takes keeps the prologues' results alive);
  c  the dots only (the prologues skipped, the codes zero-filled);
  d  without the two grid syncs (each becomes a block barrier): timing
     only, its output is not the block's.

Each is timed at the Llama-3.1-8B widths (H 4096, F 14336, int4, bf16, 32
layers of random weights, silu) by CUDA graph replay, over one decode step
of 32 launches, at 1 and 8 rows. Form "a" is held to the plain version
first: phase A's x2 and, from the kernel's own x2 and h, phase C's output,
within ``chip_smoke``'s one-step limit.

Point ``--csrc`` at the ``csrc`` directory of a version with that kernel,
for example ``git archive 99a6263 metalchat_tpu_torch/csrc | tar -x -C
archive/pr7``, and run on a machine with an H100 from the repository root:
``python3 experiments/ffn_block_split.py --csrc
archive/pr7/metalchat_tpu_torch/csrc``. The builds go to
``metalchat_tpu_torch/build/ffn_split/``.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from metalchat_tpu_torch.ops import _build  # noqa: E402

OUT = _build.BUILD_DIR / "ffn_split"

# Anchors in ffn_block.cu: the prologue helper's first line, the three dot
# loops, and the grid syncs.
PROLOGUE = "  for (int b = 0; b < B; ++b) {\n    int8_t* row = xq + (size_t)b * n;"
LOOPS = ("  for (int o = first; o < H; o += stride) {",
         "  for (int j = first; j < F; j += stride) {")
SYNC = "  grid.sync();"
SKIP_PROLOGUE = """#ifdef SKIP_PROLOGUE
  for (int i = threadIdx.x; i < B * n / 16; i += blockDim.x)
    reinterpret_cast<int4*>(xq)[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < B) { sx[threadIdx.x] = 1.f; corr[threadIdx.x] = 0; }
  __syncthreads();
  return;
#endif
"""
# After the prologue: a store that no run takes, which the compiler cannot
# rule out, so the prologue's results stay live when the dots are skipped.
SINK = """#ifdef SKIP_DOT
  if (threadIdx.x == 0 && sx[0] == -1.f && xq[(size_t)B * n - 1] == 3) split_sink = corr[0];
#endif
"""
HEADER = """#ifdef SKIP_DOT
__device__ int split_sink;
#define FIRST (1 << 30)
#else
#define FIRST first
#endif
#ifdef NO_SYNC
#define GRID_SYNC() __syncthreads()
#else
#define GRID_SYNC() grid.sync()
#endif
"""
FORMS = (("a", None), ("b", "SKIP_DOT"), ("c", "SKIP_PROLOGUE"), ("d", "NO_SYNC"))


def build(csrc: Path, name: str, define):
    text = (csrc / "ffn_block.cu").read_text()
    counts = {PROLOGUE: 1, LOOPS[0]: 2, LOOPS[1]: 1, SYNC: 2, "  __syncthreads();\n}\n": 1}
    for anchor, want in counts.items():
        if text.count(anchor) != want:
            raise SystemExit(f"{csrc / 'ffn_block.cu'} is not the kernel this script splits "
                             f"(anchor {anchor!r}): point --csrc at a version that has it")
    text = text.replace(PROLOGUE, SKIP_PROLOGUE + PROLOGUE)
    # quantize_rows ends with the only "__syncthreads();" directly before "}".
    text = text.replace("  __syncthreads();\n}\n", "  __syncthreads();\n" + SINK + "}\n")
    for loop in LOOPS:
        text = text.replace(loop, loop.replace("first;", "FIRST;"))
    text = text.replace(SYNC, "  GRID_SYNC();")
    text = text.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + HEADER)
    src = OUT / f"{name}.cu"
    src.write_text((f"#define {define}\n" if define else "") + text)
    lib = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib), str(src)]
    log = open(OUT / f"{name}.log", "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC,
                    help="the csrc directory whose ffn_block_kernel is split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ffn_block_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {v: build(args.csrc.resolve(), v, d) for v, d in FORMS}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for v, (proc, path) in procs.items():
        if proc.wait():
            print((OUT / f"{v}.log").read_text()[-3000:], file=sys.stderr)
            return 1
        libs[v] = ctypes.CDLL(str(path))
        libs[v].ffn_block.argtypes = [P] * 12 + [I] * 7 + [F, F, P]
        libs[v].ffn_block.restype = I
    from metalchat_tpu_torch.ops import ffn_block as fb

    torch.set_grad_enabled(False)
    sm = chip_smoke.Smoke(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L, H, Fi, eps = 32, 4096, 14336, 1e-5
    w = chip_smoke.ffn_weights(torch, L, H, Fi, 4, gen, dev, torch.bfloat16)
    for rows in (1, 8):
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))
        x2 = torch.empty_like(x)
        h = torch.empty((rows, Fi), dtype=x.dtype, device=dev)
        out = torch.empty_like(x)

        def call(lib, l):
            rc = lib.ffn_block(attn.data_ptr(), x.data_ptr(), w["wo_q"][l].data_ptr(),
                               w["wo_s"][l].data_ptr(), w["norm_w"][l].data_ptr(),
                               w["w13_q"][l].data_ptr(), w["w13_s"][l].data_ptr(),
                               w["w2_q"][l].data_ptr(), w["w2_s"][l].data_ptr(), x2.data_ptr(),
                               h.data_ptr(), out.data_ptr(), rows, H, Fi, 4, 0, 1, 1, eps, 0.0,
                               _build.stream_ptr(x))
            assert rc == 0, rc

        call(libs["a"], 0)
        what = f"ffn_block form a, {rows} row(s)"
        sm.close("ffn_block", x2, fb.wo_stage(attn, x, w["wo_q"][0], w["wo_s"][0], bits=4),
                 what + " phase A (x2)")
        sm.close("ffn_block", out, fb.w2_stage(h, x2, w["w2_q"][0], w["w2_s"][0], bits=4)[0],
                 what + " phase C (out)")
        times = {v: L * sm.device_ms(lambda i, lib=lib: call(lib, i % L), 64)
                 for v, lib in libs.items()}
        print(f"ffn_block at {rows} row(s), one decode step ({L} launches): "
              + ", ".join(f"{v} {ms:.4f} ms" for v, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
