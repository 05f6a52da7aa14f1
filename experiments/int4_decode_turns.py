"""8b-int4 batch-1 decode of two checkouts of the port, in turns.

Each turn is a fresh process that imports ``metalchat_tpu_torch`` from one
checkout (this repository, or ``--other DIR``, for example the parent
commit unpacked with ``git archive HEAD^ | tar -x -C archive/parent``),
builds the kernels of the path from that checkout's sources, makes
``chip_smoke.py``'s 8b-int4 model (Llama-3.1-8B widths, all 32 layers,
weight-only int4, group 32, random weights from seed 0, wqkv and w13 fused,
int8 KV, context 1024) and runs ``generate`` on a random 512-token prompt:
three times 1 then 65 new tokens, decode tok/s from the difference (64
steps). During one extra 65-token run every call of the dequant matmul's
wrapper (row 11) is timed on the host clock, so a turn reports how much of
a step's wall the wrapper's host work takes. The order is other, repo,
repo, other. Run on a machine with an H100, from the repository root:

    python3 experiments/int4_decode_turns.py --other archive/parent
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def turn(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import metalchat_tpu_torch.quant.quantize as qq
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.ops import _build, launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    assert Path(_build.__file__).resolve().is_relative_to(Path(root).resolve())
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    _build.build_all(["quant_matmul", "decode_attention", "flash_attention"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg = LlamaConfig.llama31_8b(max_seq_len=1024)
    params = fuse_projections(init_random_quantized_params(
        cfg, max_seq_len=1024, seed=0, device=dev, bits=4, group_size=32), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device=dev)

    def run(n_new):
        cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(params, cfg, prompt, max_new_tokens=n_new, cache=cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    tok_s = []
    for _ in range(3):
        first = run(1)
        tok_s.append(64 / (run(65) - first))
    kernel, host = qq.dequant_matmul, []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = kernel(*args, **kwargs)
        host.append(time.perf_counter() - t)
        return out

    qq.dequant_matmul = timed
    reset_launch_counts()
    try:
        first = run(1)
        n_prefill = len(host)
        wall = run(65) - first
    finally:
        qq.dequant_matmul = kernel
    decode_calls = host[n_prefill:][-64 * (4 * cfg.num_layers + 1):]
    return dict(root=root, build_s=build_s, tok_s=tok_s, median_tok_s=statistics.median(tok_s),
                timed_step_ms=1e3 * wall / 64,
                wrapper_host_ms_a_step=1e3 * sum(decode_calls) / 64,
                wrapper_calls_a_step=len(decode_calls) / 64,
                quant_matmul_launches=launch_counts()["quant_matmul"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("int4_decode_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("--other is required")
    other = str(Path(args.other).resolve())
    for label, root in (("other", other), ("repo", str(REPO)), ("repo", str(REPO)),
                        ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--turn", root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label}: decode {', '.join(f'{v:.2f}' for v in res['tok_s'])} tok/s (median "
              f"{res['median_tok_s']:.2f}); timed run {res['timed_step_ms']:.3f} ms a step, "
              f"the dequant-matmul wrapper {res['wrapper_host_ms_a_step']:.3f} ms of it on the "
              f"host ({res['wrapper_calls_a_step']:.0f} calls); build {res['build_s']:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
