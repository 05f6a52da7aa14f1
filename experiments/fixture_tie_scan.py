"""Near ties in the fixture's greedy tokens, by prompt slice, on the CPU.

``chip_smoke.py``'s fixture-int phase holds the kernels on the card to the
plain path on the CPU by the first 16 greedy tokens of 3 requests of 48
prompt tokens, in bf16. Two implementations that sum in different orders
can part wherever the top two logits of a step lie within a bf16 step or
two of each other. For each slice of 144 eval tokens this prints, per
quantization mode of ``chip_smoke.FIXTURE_INT_MODES``, the smallest gap
between the top two logits over the 3 x 16 generated positions, in bf16
steps of the top logit (logits of one prefill over the prompt and the
CPU's own 16 tokens). Run from the repository root on any machine:
``python3 experiments/fixture_tie_scan.py``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.cache import QuantizedKVCache  # noqa: E402
from metalchat_tpu_torch.engine.generate import generate  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402

PROMPT, REQUESTS, NEW = 48, 3, 16


def main() -> None:
    torch.set_grad_enabled(False)
    models, tokens = {}, None
    for mode, (quant, ffn_block) in cs.FIXTURE_INT_MODES.items():
        params, cfg, fixture = cs.fixture_params(torch, "cpu", torch.bfloat16, quant)
        models[mode] = (params, cfg, ffn_block)
        tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
    span = PROMPT * REQUESTS
    for start in range(0, 12 * span, span):
        prompts = torch.from_numpy(tokens[start:start + span].reshape(REQUESTS, PROMPT))
        gaps = {}
        for mode, (params, cfg, ffn_block) in models.items():
            out = generate(params, cfg, prompts, max_new_tokens=NEW, quantized_kv=True,
                           ffn_block=ffn_block)
            seq = torch.cat([prompts, out[:, :NEW]], dim=1)
            cache = QuantizedKVCache.create(cfg, REQUESTS, 256, device="cpu")
            logits, _ = forward(params, cache, seq, 0, cfg)
            top = torch.topk(logits[:, PROMPT - 1:PROMPT - 1 + NEW].float(), 2, dim=-1).values
            step = 2.0 ** (torch.floor(torch.log2(top[..., 0].abs())) - 7)
            gaps[mode] = float(((top[..., 0] - top[..., 1]) / step).min())
        print(f"eval_tokens[{start}:{start + span}]: smallest top-2 gap in bf16 steps "
              + ", ".join(f"{m} {g:g}" for m, g in gaps.items()), flush=True)


if __name__ == "__main__":
    main()
