"""Batch-1 decode of two checkouts of the port, in turns.

Each turn is a fresh process that imports ``metalchat_tpu_torch`` from one
checkout (this repository, or ``--other DIR``, for example the parent
commit unpacked with ``git archive HEAD^ | tar -x -C archive/parent``),
builds the kernels of the path from that checkout's sources, makes one of
``chip_smoke.py``'s 8B models (Llama-3.1-8B widths, all 32 layers, random
weights from seed 0, wqkv and w13 fused, int8 KV, context 1024) and runs
``generate`` on a random 512-token prompt: three times 1 then 65 new
tokens, decode tok/s from the difference (64 steps; in a checkout whose
``generate`` replays a captured CUDA graph, through that graph). ``--scheme int4`` is
8b-int4 (weight-only int4, group 32; the linear wrapper timed is the
dequant matmul's, row 11), ``--scheme w4a8`` is 8b-w4a8 (per-channel int4,
int8 activations; the fused W4A8 matvec's, row 1). During one extra
65-token run of the eager loop (a prefill, then one `forward` call a
token, greedy: the loop ``generate`` ran before it was captured) every call of that
wrapper is timed on the host clock, so a turn reports how much of an
eager step's wall the wrapper's host work takes. The
wall of a step spreads with the host's load, so the turn also replays one
decode step's wrapper calls (the same arguments, 20 steps back to back, five
times) and reports the host time a replayed step, least and median: the
wrapper's own host cost, with little else in the loop. The order is other,
repo, repo, other. Run on a machine with an H100, from the
repository root:

    python3 experiments/decode_turns.py --scheme w4a8 --other archive/parent
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


SCHEMES = {"int4": dict(bits=4, group_size=32), "w4a8": dict(bits=4, group_size=None, act_bits=8)}


def turn(root: str, scheme: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import metalchat_tpu_torch.models.decode as md
    import metalchat_tpu_torch.quant.quantize as qq
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.config import LlamaConfig
    from metalchat_tpu_torch.engine.generate import generate
    from metalchat_tpu_torch.models.fuse import fuse_projections
    from metalchat_tpu_torch.models.transformer import forward
    from metalchat_tpu_torch.ops import _build, launch_counts, reset_launch_counts
    from metalchat_tpu_torch.quant.quantize import init_random_quantized_params

    assert Path(_build.__file__).resolve().is_relative_to(Path(root).resolve())
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    _build.build_all(["quant_matmul" if scheme == "int4" else "a8_matvec", "decode_attention",
                      "flash_attention"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg = LlamaConfig.llama31_8b(max_seq_len=1024)
    params = fuse_projections(init_random_quantized_params(
        cfg, max_seq_len=1024, seed=0, device=dev, **SCHEMES[scheme]), cfg)
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

    def eager(n_new):
        cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = forward(params, cache, prompt, 0, cfg)
        for i in range(n_new - 1):
            tok = logits[:, -1].argmax(-1)
            logits, _ = forward(params, cache, tok[:, None], prompt.shape[1] + i, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    tok_s = []
    for _ in range(3):
        first = run(1)
        tok_s.append(64 / (run(65) - first))
    # The wrapper as the decode path calls it: by the name its module imported.
    module, name = (qq, "dequant_matmul") if scheme == "int4" else (
        md, "quant_matvec_stacked_fused")
    kernel, host, calls = getattr(module, name), [], []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = kernel(*args, **kwargs)
        host.append(time.perf_counter() - t)
        calls.append((args, kwargs))
        return out

    setattr(module, name, timed)
    reset_launch_counts()
    try:
        first = eager(1)
        n_prefill = len(host)
        wall = eager(65) - first
    finally:
        setattr(module, name, kernel)
    per_step = 4 * cfg.num_layers + 1
    decode_calls = host[n_prefill:][-64 * per_step:]
    launches = launch_counts()
    one_step = calls[len(calls) - 64 * per_step:][:per_step]
    replay = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            for args, kwargs in one_step:
                kernel(*args, **kwargs)
        replay.append((time.perf_counter() - t) / 20)
    torch.cuda.synchronize()
    return dict(root=root, build_s=build_s, tok_s=tok_s, median_tok_s=statistics.median(tok_s),
                timed_step_ms=1e3 * wall / 64,
                wrapper_host_ms_a_step=1e3 * sum(decode_calls) / 64,
                wrapper_calls_a_step=len(decode_calls) / 64, launches=launches,
                replay_host_ms_a_step=[1e3 * v for v in replay])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--scheme", choices=sorted(SCHEMES), default="int4")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.scheme)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("decode_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("--other is required")
    other = str(Path(args.other).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for label, root in (("other", other), ("repo", str(REPO)), ("repo", str(REPO)),
                        ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--turn", root, "--scheme", args.scheme],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        launched = {k: v for k, v in res["launches"].items() if v}
        print(f"{label} 8b-{args.scheme}: decode {', '.join(f'{v:.2f}' for v in res['tok_s'])} "
              f"tok/s (median {res['median_tok_s']:.2f}); timed run {res['timed_step_ms']:.3f} "
              f"ms a step, the linear wrapper {res['wrapper_host_ms_a_step']:.3f} ms of it on "
              f"the host ({res['wrapper_calls_a_step']:.0f} calls); replayed, the wrapper "
              f"{min(res['replay_host_ms_a_step']):.3f} ms a step on the host (least; median "
              f"{statistics.median(res['replay_host_ms_a_step']):.3f}); launches {launched}; "
              f"build {res['build_s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
