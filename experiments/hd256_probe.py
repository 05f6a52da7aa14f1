"""First look at the attention kernels' head_dim-256 instances on the card.

Builds every kernel, prints the registers and spill bytes of the decode,
paged and flash attention instances (and any ptxas warning, such as C7514,
wgmma serialized), runs ``chip_smoke.gemma_kernel_checks`` (rows 1, 3, 4, 5
and 8 at Gemma-3-1B's shapes against their plain versions), then times the
bf16 flash kernel at hd 256 over a 640-token prompt, with a window of 512
and global, beside SDPA's causal call on the same K/V (heads repeated). Run
on a machine with an H100, from the repository root:

    python3 experiments/hd256_probe.py
"""

import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from metalchat_tpu_torch.ops import _build
    from metalchat_tpu_torch.ops.flash_attention import flash_attention

    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    print(f"build {_build.build_all():.1f} s", flush=True)
    for name in ("decode_attention", "paged_attention", "flash_attention"):
        log = _build.build_log(name)
        for fn, regs, spill in cs.entry_functions(log):
            print(f"  {name} {fn}: {regs} registers, spill stores/loads {spill} bytes")
        for line in log.splitlines():
            if "C7514" in line or "warning" in line.lower():
                print("   ", line.strip())
    sm = cs.Smoke(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ok = True
    try:
        cs.gemma_kernel_checks(sm, gen, dev)
    except Exception:  # noqa: BLE001 — report, then time what builds
        traceback.print_exc()
        ok = False
    print("max |kernel - plain|:", sm.err)
    print("share of the limit:", sm.share)
    q = torch.randn((1, 640, 4, 256), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 1, 640, 256), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    for window in (512, -1):
        ms = sm.device_ms(lambda i: flash_attention(q, k, v, 0, scale=256 ** -0.5,
                                                    window=window), 16)
        print(f"flash hd 256, S 640, window {window}: {1e3 * ms:.2f} us")
    kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
    ms = sm.device_ms(lambda i: F.scaled_dot_product_attention(
        q.transpose(1, 2), kr, vr, is_causal=True), 16)
    print(f"sdpa causal, the same K/V: {1e3 * ms:.2f} us")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), f"; {time.perf_counter() - t0:.1f} s",
          "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
