"""Which int8 codes of the normed row move in the merged FFN block's phase
B, on the draw where ``chip_smoke.check_ffn_block`` fails its phase-B limit.

``chip_smoke.phase_kernels`` runs as written, except that the qlora-1b
row-11 checks (``QMM_QLORA_1B``) draw from the phase's shared generator
instead of their own (the draw on which phase B failed), the later checks
are skipped, and the FFN check covers one row only and is replaced by a
diagnostic. For each case it prints: where row 1's ``a8_quantize`` kernel
(the same norm prologue, whose codes reproduce the block's h) puts codes
other than the plain prologue's, whether the plain phase B on those codes
gives the kernel's h bit for bit, and the worst share of the phase-B limit
with an allowance of one and of two moved codes.

Run on a machine with an H100 from the repository root:
``python3 experiments/ffn_phase_b_codes.py``.
"""
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from metalchat_tpu_torch.ops import ffn_block as m  # noqa: E402
from metalchat_tpu_torch.ops.a8_matvec import prologue, quantize_rows  # noqa: E402

# The fixed one-code allowance this diagnosis was written against (largest
# |weight code| a width): `chip_smoke.check_ffn_block` now bounds phase B by
# the codes that moved.
QMAX = {4: 8, 8: 127}


def diag_ffn(sm, H, F, rows, cases, gen, dev, dtype=None, L=2):
    """`chip_smoke.check_ffn_block`'s draws, each case diagnosed (printed)."""
    dtype = dtype or torch.bfloat16
    weights = {}
    for bits, act, offset, layer in cases:
        if bits not in weights:
            weights[bits] = cs.ffn_weights(torch, L, H, F, bits, gen, dev, dtype)
        w = weights[bits]
        attn, x = (torch.randn((rows, H), generator=gen, device=dev).to(dtype) for _ in range(2))
        scratch = {}
        m.ffn_block_stacked(attn, x, *w.values(), layer, bits=bits, act=act, eps=1e-5,
                            offset=offset, scratch=scratch)
        x2, h = scratch["x2"], scratch["h"]
        h_ref, gate, up, sx_n = m.w13_stage(x2, w["norm_w"][layer], w["w13_q"][layer],
                                            w["w13_s"][layer], bits=bits, act=act, eps=1e-5,
                                            offset=offset)
        s13 = w["w13_s"][layer].reshape(-1).float()
        dg, du = (sx_n * s13[None, sl] * QMAX[bits] for sl in (slice(0, F), slice(F, None)))
        one = (cs.ACT_SLOPE * up.abs() * dg + m.activation(gate, act).abs() * du
               + cs.ACT_SLOPE * dg * du)
        diff = (h.float() - h_ref.float()).abs()
        lim = cs.RTOL["bfloat16"] * h_ref.float().abs() + cs.ATOL_OF_MAX * h_ref.float().abs().max()
        share1 = (diff / (lim + one)).max().item()
        share2 = (diff / (lim + 2 * one)).max().item()
        # The plain normed row before rounding: distance of each value to a .5 boundary.
        xq, sx = prologue(x2, w["norm_w"][layer], 1e-5, offset)
        xf = x2.float()
        normed = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
                  * (offset + w["norm_w"][layer].float())).to(x2.dtype).float() / sx
        frac = (normed - normed.floor() - 0.5).abs()
        near = [(int((frac < t).sum())) for t in (1e-5, 1e-4, 1e-3)]
        xq_k, sx_k, _ = quantize_rows(x2, w["norm_w"][layer], 1e-5, offset)
        n_diff = int((xq_k != xq).sum())
        where = (xq_k != xq).nonzero().tolist()
        gk, uk = m._linear(xq_k, sx_k.reshape(-1, 1), w["w13_q"][layer], w["w13_s"][layer],
                           bits).chunk(2, dim=-1)
        h_k = (m.activation(gk, act) * uk).to(x2.dtype)
        col = [int(w["w13_q"][layer][:, k[1]].abs().max()) for k in where]
        print(f"  a8_quantize codes differ from the plain prologue's at {n_diff} "
              f"({where[:4]}, |w13 column| max {col[:4]}), sx equal "
              f"{bool(torch.equal(sx_k.reshape(-1), sx.reshape(-1)))}; h from those codes equals "
              f"the kernel's h: {bool(torch.equal(h_k, h))}; max |h_k - h| "
              f"{(h_k.float() - h.float()).abs().max().item()}", flush=True)
        print(f"ffn w{bits} B={rows} {act} off={offset} l={layer}: phase B share with one "
              f"code {share1:.3f}, with two {share2:.3f}; normed values within 1e-5/1e-4/1e-3 "
              f"of a .5 boundary: {near}", flush=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    sm = cs.Smoke(torch)
    cs.phase_build()
    orig_qmm, state = cs.check_qmm, {}

    def shared_gen_qmm(sm, shapes, rows, gen, dev, dtype=None, scales_dtype=None):
        """The QLoRA shapes drawn from the phase's shared generator."""
        if shapes is cs.QMM_QLORA_1B:
            gen = state["gen"]
        else:
            state["gen"] = gen
        return orig_qmm(sm, shapes, rows, gen, dev, dtype, scales_dtype)

    cs.check_qmm = shared_gen_qmm
    cs.check_ffn_block = diag_ffn
    cs.FFN_ROWS = (1,)
    for name in ("check_graph_replay", "speculative_kernel_checks", "gemma_kernel_checks",
                 "mixtral_kernel_checks", "gpt2_kernel_checks"):
        setattr(cs, name, lambda *a, **k: None)
    cs.phase_kernels(sm)


if __name__ == "__main__":
    main()
