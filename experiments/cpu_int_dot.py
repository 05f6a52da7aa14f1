"""Where the CPU references of phases mixtral-fixture and ppl spend their
time: the exact int32 product of the act8 plain path (`ops.a8_matvec.int_dot`
on the CPU) as an int32 ``@`` of widened copies against ``torch._int_mm``
(the plain version `int_dot` takes now), each timed on the host clock:

* the product alone at the mixtral-fixture prefill's widest shape, int8
  ``[96, 4096] · [14336, 4096]ᵀ`` (one call after a warm-up), and whether
  both give the same int32s;
* mixtral-fixture's CPU reference at one row (`chip_smoke.greedy_logits`,
  prompt 96, 4 steps, the 2-layer cut made on the card and copied) with
  each product;
* `ppl`'s CPU perplexity of the fixture's W4A8 tree (its 4 batches of 4 ×
  128 tokens) with each product.

Prints each time and the card's name and power limit. Run on a machine with
an H100 from the repository root: ``python3 experiments/cpu_int_dot.py``.
"""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.ops import a8_matvec  # noqa: E402
from metalchat_tpu_torch.quant import quantize as qmod  # noqa: E402


def int32_matmul(a, b):
    """The CPU plain product before: an int32 ``@`` of widened copies."""
    return a.int() @ b.int().T


PRODUCTS = {"int32 @": int32_matmul, "torch._int_mm": a8_matvec.int_dot}


def use(product) -> None:
    a8_matvec.int_dot = qmod.int_dot = product


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def main() -> None:
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, {torch.get_num_threads()} CPU threads", flush=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    a = torch.randint(-127, 128, (96, 4096), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (14336, 4096), generator=gen, dtype=torch.int8)
    outs = {}
    for name, product in PRODUCTS.items():
        product(a, b)
        outs[name], secs = timed(lambda: product(a, b))
        print(f"[96, 4096] x [14336, 4096]^T on the CPU, {name}: {secs:.4f} s", flush=True)
    print(f"  the same int32s: {torch.equal(*outs.values())}", flush=True)

    sm = cs.Smoke(torch)
    cfg, card = cs.make_mixtral(sm, "cuda", **cs.MIXTRAL_FIXTURE_CUT)
    cpu = cs.to_device(card, torch.device("cpu"))
    del card
    gen.manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, cs.MIXTRAL_FIXTURE_PROMPT), generator=gen)
    ids = {}
    for name, product in PRODUCTS.items():
        use(product)
        (ids[name], _), secs = timed(lambda: cs.greedy_logits(cpu, cfg, prompt,
                                                               cs.MIXTRAL_FIXTURE_STEPS))
        print(f"mixtral-fixture's CPU reference, one row, {name}: {secs:.2f} s", flush=True)
    print(f"  the same ids: {torch.equal(*ids.values())}", flush=True)
    del cpu

    from metalchat_tpu_torch.config import load_config
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.safetensors import open_safetensors
    from metalchat_tpu_torch.quant.ppl import token_nll

    fixture = Path("tests/fixtures/pyllama_10m")
    fcfg = load_config(fixture / "config.json")
    tokens = np.load(fixture / "eval_tokens.npy").astype(np.int64)
    n = cs.PPL_ROWS * cs.PPL_LEN
    batches = [tokens[i * n:(i + 1) * n].reshape(cs.PPL_ROWS, cs.PPL_LEN)
               for i in range(cs.PPL_BATCHES)]
    ref = load_params(open_safetensors(fixture), fcfg, dtype=torch.bfloat16, device="cpu")
    tree = cs.ppl_candidate(cs.PPL_MODES["w4a8"], ref, fcfg, None)
    for name, product in PRODUCTS.items():
        use(product)
        nll, secs = timed(lambda: [float(token_nll(tree, fcfg, torch.from_numpy(x)))
                                   for x in batches])
        print(f"ppl's CPU perplexity of the w4a8 tree, {name}: {secs:.2f} s "
              f"(perplexity {float(np.exp(np.mean(nll))):.6f})", flush=True)


if __name__ == "__main__":
    main()
