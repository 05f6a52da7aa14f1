"""Decode and paged attention (rows 3, 5, 8 and 9) from two versions of
their sources, timed in turns within one call.

Builds ``decode_attention.cu`` and ``paged_attention.cu`` of the repository
and of another version's ``csrc`` directory (``--baseline DIR``, holding
those files and their headers), one ``nvcc`` each, all at once, into
``metalchat_tpu_torch/build/`` (the baseline under ``attn_turns/``). Both
versions must keep the C entry points' signatures: each is timed through
the repository's wrappers
with the library swapped, by CUDA graph replay, at Llama-3.1-8B widths
(32 layers, 32 query and 8 kv heads, hd 128, bf16 activations, random int8
K/V and scales):

  row 3  write mode, dense int8 cache, batch 1, lengths 64, 576 and 1024
         (chip_smoke.py's generate shapes);
  row 5  read-only over a bf16 cache, 8 rows, lengths 128..1024;
  row 8  paged write mode, 8 rows, pages of 256, lengths 128..1024;
  row 9  the same, read-only (chip_smoke.py's serve shapes).

One decode step is 32 calls, one a layer. The order is repo, baseline,
baseline, repo. Each version's outputs are held once against the plain
version (``chip_smoke``'s limit). Run on a machine with an H100, from the
repository root, for example against the parent commit:

    git archive HEAD^ metalchat_tpu_torch/csrc | tar -x -C archive/base
    python3 experiments/attn_body_turns.py --baseline archive/base/metalchat_tpu_torch/csrc
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.ops import _build  # noqa: E402
from metalchat_tpu_torch.ops import decode_attention as dm  # noqa: E402
from metalchat_tpu_torch.ops import paged_attention as pm  # noqa: E402

SOURCES = ("decode_attention", "paged_attention")
ENTRIES = {"decode_attention": ("decode_attention_update", "decode_attention"),
           "paged_attention": ("paged_attention",)}


def build(csrc: Path, out: Path) -> dict:
    """{"repo": {source: CDLL}, "baseline": {source: CDLL}}: the baseline
    built beside the repo's own build, with the argtypes of the repo's
    wrappers."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in Path(csrc).glob("*.cuh"):
        shutil.copy(f, out / f.name)
    procs = {}
    for name in SOURCES:
        shutil.copy(Path(csrc) / f"{name}.cu", out / f"{name}.cu")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=open(out / f"{name}.log", "w"),
            stderr=subprocess.STDOUT)
    _build.build_all(SOURCES)
    libs = {"repo": {"decode_attention": dm._lib(), "paged_attention": pm._lib()},
            "baseline": {}}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError((out / f"{name}.log").read_text()[-3000:])
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for entry in ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = getattr(libs["repo"][name], entry).argtypes, ctypes.c_int
        libs["baseline"][name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="the other version's csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_body_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    libs = build(Path(args.baseline), _build.BUILD_DIR / "attn_turns")
    sm = cs.Smoke(torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    L, nh, nkv, hd, T = 32, 32, 8, 128, 1024
    scale = hd ** -0.5

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.001

    # Row 3: a dense int8 cache of one row.
    dense1 = (codes(L, 1, nkv, T, hd), codes(L, 1, nkv, T, hd), scales(L, 1, nkv, T),
              scales(L, 1, nkv, T))
    q1 = torch.randn((1, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn1 = torch.randn((1, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    # Rows 5, 8, 9: 8 rows of lengths 128..1024; pages of 256, 4 a row, shuffled.
    B, psize, mp = 8, 256, 4
    lengths = [(i + 1) * mp * psize // B for i in range(B)]
    lens8 = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q8 = torch.randn((B, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    kn8 = torch.randn((B, nkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((L, B, nkv, T, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    pool = (codes(L, nkv, B * mp + 1, psize, hd), codes(L, nkv, B * mp + 1, psize, hd),
            scales(L, B * mp + 1, nkv, psize), scales(L, B * mp + 1, nkv, psize))
    table = torch.randperm(B * mp, generator=gen, device=dev).to(torch.int32).reshape(B, mp)

    def cases():
        out = []
        for n in (64, 576, 1024):
            lens = torch.tensor([n], dtype=torch.int32, device=dev)
            out.append((f"row 3 length {n}", "decode_attention_update",
                        lambda i, lens=lens: dm.decode_attention_update_quantized_stacked(
                            q1, kn1, kn1, *dense1, i % L, lens, scale=scale),
                        lambda lens=lens: dm.decode_attention_update_plain(
                            q1, kn1, kn1, *dense1, 0, lens, scale=scale)))
        out.append(("row 5 8 rows bf16", "decode_attention",
                    lambda i: dm.decode_attention_stacked(q8, kc, vc, i % L, lens8, scale=scale),
                    lambda: dm.decode_attention_stacked_plain(q8, kc, vc, None, None, 0, lens8,
                                                              scale=scale)))
        out.append(("row 8 paged write", "paged_decode_attention_update",
                    lambda i: pm.paged_decode_attention_update_stacked(
                        q8, kn8, kn8, *pool, table, lens8, i % L, scale=scale),
                    lambda: pm.paged_decode_attention_update_plain(
                        q8, kn8, kn8, *pool, table, lens8, 0, scale=scale)))
        out.append(("row 9 paged read", "paged_decode_attention",
                    lambda i: pm.paged_decode_attention_stacked(q8, *pool, table, lens8, i % L,
                                                                scale=scale),
                    lambda: pm.paged_decode_attention_plain(q8, *pool, table, lens8, 0,
                                                            scale=scale)))
        return out

    # The write modes store the same codes on every call, so repeated calls
    # (and both versions) see the same cache.
    for version in ("repo", "baseline", "baseline", "repo"):
        dm._lib = lambda v=version: libs[v]["decode_attention"]
        pm._lib = lambda v=version: libs[v]["paged_attention"]
        times = {}
        for label, kernel, fn, plain in cases():
            got = fn(0)
            want = plain()
            sm.close(kernel, got[0] if isinstance(got, tuple) else got,
                     want[0] if isinstance(want, tuple) else want, f"{version} {label}")
            times[label] = L * sm.device_ms(fn, 64)
        print(f"{version}: ms a decode step ({L} calls) " + ", ".join(
            f"{k} {v:.5f}" for k, v in times.items()), flush=True)
    print("worst shares of the limit " + ", ".join(
        f"{k} {v:.3f}" for k, v in sm.share.items() if v), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
