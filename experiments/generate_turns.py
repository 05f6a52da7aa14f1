"""Batch-1 decode through the captured CUDA graph against the eager loop,
in repeated turns.

Makes ``chip_smoke.py``'s 8B model of ``--scheme`` (Llama-3.1-8B widths, all
32 layers, random weights from seed 0, wqkv and w13 fused, int8 KV, context
1024), then runs ``chip_smoke.graph_vs_eager`` ``--rounds`` times on one
random 512-token prompt: each round checks the graph route's 65 ids and
cache against the eager loop's (bit for bit), times both routes in turns
(graph, eager, eager, graph; 64 / (t(65) - t(1)), the graph's warm-up step
and capture inside its t(65)), the capture alone and 63 replays alone. The
rounds show how far the host's pace spreads one turn. Run on a machine with
an H100, from the repository root:

    python3 experiments/generate_turns.py --scheme w4a8 --rounds 4
"""

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SCHEMES = {"w4a8": dict(bits=4, group_size=None, act_bits=8),
           "int4": dict(bits=4, group_size=32)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scheme", choices=sorted(SCHEMES), default="w4a8")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ffn-block", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("generate_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from metalchat_tpu_torch.cache import QuantizedKVCache
    from metalchat_tpu_torch.engine import generate
    from metalchat_tpu_torch.ops import _build

    torch.set_grad_enabled(False)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    sm = chip_smoke.Smoke(torch)
    label = f"8b-{args.scheme}" + (" ffn_block" if args.ffn_block else "")
    cfg, params = chip_smoke.make_8b(sm, label, **SCHEMES[args.scheme])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device=dev)
    for r in range(args.rounds):
        cache = QuantizedKVCache.create(cfg, 1, 1024, device=dev)
        out = generate(params, cfg, prompt, max_new_tokens=65, cache=cache,
                       ffn_block=args.ffn_block)
        chip_smoke.graph_vs_eager(sm, f"{label} round {r}", cfg, params, prompt, out, cache,
                                  args.ffn_block, 1024, 64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
