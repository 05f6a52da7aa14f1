"""Where `gptq_quantize_params`' time goes at Llama-3.2-1B's widths on the
card: each calibration tap's leaves (wq/wk/wv side by side, wo, w1/w3, w2)
through `quant.gptq._gptq_codes` alone, all 16 layers in the module's layer
chunks, ``refit_iters=2``; then one layer of each with ``refit_iters=0``.
Random dense bf16 weights and calibration tokens as
``chip_smoke.phase_gptq_1b`` draws them (no AWQ fold); host clock around
each call, ending in ``synchronize``.

Run on a machine with an H100 from the repository root:
``python3 experiments/gptq_split.py``.
"""
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.config import config_from_dict  # noqa: E402
from metalchat_tpu_torch.models.transformer import init_random_params  # noqa: E402
from metalchat_tpu_torch.quant import gptq  # noqa: E402
from metalchat_tpu_torch.quant.awq import calibration_stats  # noqa: E402

GROUPS = {"qkv": ("wq", "wk", "wv"), "wo": ("wo",), "w13": ("w1", "w3"), "w2": ("w2",)}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    cfg = config_from_dict(cs.LLAMA32_1B_CONFIG).replace(max_seq_len=1024)
    dev = torch.device("cuda")
    params = init_random_params(cfg, seed=0, dtype=torch.bfloat16, max_seq_len=1024,
                                device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    calib = torch.randint(0, cfg.vocab_size, cs.GPTQ_CALIB, generator=gen, device=dev)
    hess = calibration_stats(params, cfg, calib, tap=gptq.hessian_tap)
    layers = params["layers"]

    def run(tap, sl=slice(None), refit=2):
        w = torch.cat([layers[n].float() for n in GROUPS[tap]], dim=-1)[sl]
        H = hess[tap][sl]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for c in gptq._chunks(w.shape[0], w.shape[-2]):
            gptq._gptq_codes(w[c].double(), H[c], qmax=7.0, clip_search=True, act_order=True,
                             damp=0.01, refit_iters=refit, failures=None)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run("wo", slice(0, 1), 0)  # warm-up
    for tap in GROUPS:
        print(f"gptq {tap} ({'+'.join(GROUPS[tap])}), 16 layers, refit 2: {run(tap):.2f} s; "
              f"layer 0 alone, refit 0: {run(tap, slice(0, 1), 0):.3f} s", flush=True)


if __name__ == "__main__":
    main()
