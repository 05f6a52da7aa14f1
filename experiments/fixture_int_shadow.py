"""Where fixture-int's greedy tokens part card against CPU, and why.

Runs the trained fixture quantized weight-only (``chip_smoke``'s "w8 g32"
and "w4 g32" modes, bf16) through ``generate`` on the CPU (plain versions)
and on the card, for two prompt slices: ``eval_tokens[:144]`` and
``chip_smoke.FIXTURE_INT_PROMPTS``. On the card every ``quant_matmul`` call
is shadowed by the plain version on the same inputs, and the worst share
of ``chip_smoke.check_qmm``'s limit is printed per shape. At the first
position where card and CPU part, the CPU's top three logits there (one
prefill over the prompt and the CPU's tokens before it) show whether that
was a near tie. Run on a machine with an H100, from the repository root:
``python3 experiments/fixture_int_shadow.py``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
import metalchat_tpu_torch.quant.quantize as qq  # noqa: E402
from metalchat_tpu_torch.cache import QuantizedKVCache  # noqa: E402
from metalchat_tpu_torch.engine.generate import generate  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402
from metalchat_tpu_torch.ops import quant_matmul as qm  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fixture_int_shadow: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    kernel = qq.dequant_matmul
    shares = {}

    def shadow(x, q, s, *, bits, group_size, transposed):
        got = kernel(x, q, s, bits=bits, group_size=group_size, transposed=transposed)
        want = qm.dequant_matmul_plain(x, q, s, bits=bits, group_size=group_size,
                                       transposed=transposed).float()
        limit = cs.RTOL["bfloat16"] * want.abs() + cs.ATOL_OF_MAX * want.abs().max()
        key = (tuple(q.shape), "transposed" if transposed else "natural", x.shape[0])
        shares[key] = max(shares.get(key, 0.0), ((got.float() - want).abs() / limit).max().item())
        return got

    for mode in ("w8 g32", "w4 g32"):
        quant, _ = cs.FIXTURE_INT_MODES[mode]
        cpu, cfg, fixture = cs.fixture_params(torch, "cpu", torch.bfloat16, quant)
        card, _, _ = cs.fixture_params(torch, "cuda", torch.bfloat16, quant)
        tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
        for where in (slice(0, 144), cs.FIXTURE_INT_PROMPTS):
            prompts = torch.from_numpy(tokens[where].reshape(3, 48))
            want = generate(cpu, cfg, prompts, max_new_tokens=16, quantized_kv=True)
            shares.clear()
            qq.dequant_matmul = shadow
            try:
                got = generate(card, cfg, prompts, max_new_tokens=16, quantized_kv=True).cpu()
            finally:
                qq.dequant_matmul = kernel
            print(f"{mode}, eval_tokens[{where.start}:{where.stop}]: first 16 identical "
                  f"{[bool(torch.equal(got[i], want[i])) for i in range(3)]}; worst share of "
                  f"the limit by call {dict(sorted((k, round(v, 3)) for k, v in shares.items()))}")
            for i in range(3):
                j = next((j for j in range(16) if got[i, j] != want[i, j]), None)
                if j is None:
                    continue
                seq = torch.cat([prompts[i:i + 1], want[i:i + 1, :j]], dim=1)
                logits, _ = forward(cpu, QuantizedKVCache.create(cfg, 1, 256, device="cpu"),
                                    seq, 0, cfg)
                top = torch.topk(logits[0, -1].float(), 3)
                print(f"  request {i} parts at token {j + 1}: CPU {want[i, j].item()}, card "
                      f"{got[i, j].item()}; CPU top-3 logits {top.values.tolist()} for "
                      f"tokens {top.indices.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
