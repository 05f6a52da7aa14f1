"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

Data crosses between the two frameworks only as numpy arrays: the JAX side
is computed and taken to numpy before any torch op runs.
"""

import numpy as np

from metalchat_tpu.quant.quantize import QuantizedTensor


def jax_tree_to_numpy(tree):
    """JAX parameter tree → nested dicts of numpy arrays, quantized leaves as
    the dicts `metalchat_tpu_torch.convert.params_from_numpy` takes."""
    if isinstance(tree, QuantizedTensor):
        assert tree.pack_chunks == 1 and tree.fuse_tp == 1
        return {"q": np.asarray(tree.q), "scales": np.asarray(tree.scales),
                "bits": tree.bits, "group_size": tree.group_size,
                "transposed": tree.transposed, "act_bits": tree.act_bits}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- the int8 tensor-core matvec's schedule (csrc/a8_matvec.cu, a8_mma_kernel) --

MMA_TILE_ROWS, MMA_SPLIT, MMA_STEP = 16, 8, 64  # kTileRows, kSplit, kStep


def _mma_layout():
    """PTX's fragment layout of mma.m16n8k32 with s8 operands, per lane
    (group g = lane // 4, thread t = lane % 4): A element i of 16 at (row,
    col), B element i of 8 at (k, n), C register i of 4 at (row, col)."""
    lane = np.arange(32)[:, None]
    g, t = lane // 4, lane % 4
    i = np.arange(16)[None, :]
    a_row = np.where((i < 4) | ((i >= 8) & (i < 12)), g, g + 8)
    a_col = 4 * t + (i & 3) + np.where(i >= 8, 16, 0)
    i = np.arange(8)[None, :]
    b_k = 4 * t + (i & 3) + np.where(i >= 4, 16, 0)
    b_n = np.broadcast_to(g, (32, 8))
    i = np.arange(4)[None, :]
    c_row = g + np.where(i >= 2, 8, 0)
    c_col = 2 * t + (i & 1)
    return a_row, a_col, b_k, b_n, c_row, c_col


def a8_mma_emulate(xq, p, bits, *, corr=None, fault=None):
    """int32 ``[B, out]`` as a8_mma_kernel computes it, register by register:
    each lane's 16-byte loads (weight rows g and g + 8, code row g of each
    n-tile; zeros past k, past out and for code rows >= B), bytes 0-7 and
    8-15 to two mmas through PTX's fragment layout, step s on warp s %
    kSplit, the warps' partials summed in warp order, then the epilogue by
    (n-tile, register, lane). ``corr`` None is raw mode (8·Σx_lo from an mma
    with an A of 8s), else the fused route's ``[B]`` from a8_quantize.
    ``fault``: "drop_step" skips step 1, "no_corr" leaves corr out, and
    "pad_leak" stores a padded code column's total into row B - 1."""
    import torch

    a_row, a_col, b_k, b_n, c_row, c_col = (torch.from_numpy(np.ascontiguousarray(m))
                                            for m in _mma_layout())
    b, in_f = xq.shape
    out_f, k = p.shape
    nt = 1 if b <= 8 else 2
    steps = -(-k // MMA_STEP)
    tiles = -(-out_f // MMA_TILE_ROWS)
    pad_k = steps * MMA_STEP - k

    def padded(m, rows):
        m = m.to(torch.int64)
        return torch.nn.functional.pad(m, (0, pad_k, 0, rows - m.shape[0]))

    w = padded(p, tiles * MMA_TILE_ROWS).reshape(tiles, 2, 8, steps, 4, 16)  # tile, half, g, s, t
    if bits == 4:
        half = in_f // 2
        ops = [(w & 15, xq[:, :half]), (w & -16, xq[:, half:])]
        if corr is None:
            ops.append((torch.full_like(w, 8), xq[:, :half]))
    else:
        ops = [(w, xq)]
    parts = []
    for wop, x in ops:
        xs = padded(x, 8 * nt).reshape(nt, 8, steps, 4, 16)  # n-tile, g, s, t
        acc = torch.zeros(tiles, nt, steps, 16, 8, dtype=torch.int64)
        for m in range(2):
            lo, hi = slice(8 * m, 8 * m + 4), slice(8 * m + 4, 8 * m + 8)
            # Lane (g, t) registers: a0 = row g bytes lo, a1 = row g + 8 lo,
            # a2 = row g hi, a3 = row g + 8 hi; b0 = code row lo, b1 = hi.
            a_regs = torch.cat([wop[:, 0, ..., lo], wop[:, 1, ..., lo],
                                wop[:, 0, ..., hi], wop[:, 1, ..., hi]], dim=-1)
            b_regs = torch.cat([xs[..., lo], xs[..., hi]], dim=-1)
            a_regs = a_regs.permute(0, 2, 1, 3, 4).reshape(tiles, steps, 32, 16)
            b_regs = b_regs.permute(0, 2, 1, 3, 4).reshape(nt, steps, 32, 8)
            a_mat = torch.zeros(tiles, steps, 16, 32, dtype=torch.int64)
            a_mat[:, :, a_row, a_col] = a_regs
            b_mat = torch.zeros(nt, steps, 32, 8, dtype=torch.int64)
            b_mat[:, :, b_k, b_n] = b_regs
            acc += torch.einsum("asmk,jskn->ajsmn", a_mat, b_mat)
        if fault == "drop_step" and steps > 1:
            acc[:, :, 1] = 0
        # Per warp (steps s with s % kSplit == w), summed in warp order.
        warps = torch.zeros(tiles, nt, MMA_SPLIT, 16, 8, dtype=torch.int64)
        for s in range(steps):
            warps[:, :, s % MMA_SPLIT] += acc[:, :, s]
        total = torch.zeros(tiles, nt, 16, 8, dtype=torch.int64)
        for wi in range(MMA_SPLIT):
            total += warps[:, :, wi]
        parts.append(total[:, :, c_row, c_col])  # [tile, j, lane, i]: the registers
    out = torch.zeros(b, out_f, dtype=torch.int64)
    for e in range(nt * 4 * 32):  # the epilogue's threads, in order
        ln, j, i = e & 31, e >> 7, (e >> 5) & 3
        o = torch.arange(tiles) * MMA_TILE_ROWS + ln // 4 + (8 if i >= 2 else 0)
        n = 8 * j + 2 * (ln % 4) + (i & 1)
        tot = [part[:, j, ln, i] for part in parts]
        if bits == 4:
            c = tot[2] if corr is None else (corr[n].long() if n < b else 0)
            value = tot[0] - (0 if fault == "no_corr" else c) + (tot[1] >> 4)
        else:
            value = tot[0]
        if n >= b:
            if fault != "pad_leak":
                continue
            n = b - 1
        live = o < out_f
        out[n, o[live]] = value[live]
    assert int(out.abs().max()) < 2 ** 31
    return out.to(torch.int32)


# -- the dequant matmul's bf16 arithmetic and schedules (csrc/quant_matmul.cu) --

def bf16_rne(v):
    """f32 → the bf16 value nearest (ties to even), as f32: the rounding of
    ``mul.rn.bf16x2`` applied to a product that f32 holds exactly."""
    import torch

    a = v.float().contiguous().numpy().view(np.uint32).astype(np.uint64)
    a = ((a + 0x7FFF + ((a >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return torch.from_numpy(a.view(np.float32))


def magic_nibbles(packed):
    """Both nibbles of int8 bytes as the kernel makes them bf16, on bit
    patterns: OR into the mantissa of 128.0 (0x4300; the high nibble XOR 8
    first), read as bf16, subtract 136. Returns (lo, hi) as f32 values."""
    import torch

    b = packed.to(torch.int32) & 0xFF
    lo_bits = (b & 0xF) | 0x4300
    hi_bits = ((b >> 4) & 0xF) ^ 0x8 | 0x4300
    as_bf16 = lambda bits: (bits << 16).view(torch.float32)  # noqa: E731  bf16 → f32 exactly
    return as_bf16(lo_bits) - 136.0, as_bf16(hi_bits) - 136.0


def _bf16_scales(scales):
    return scales.to(__import__("torch").bfloat16).float()


def lean_dequant(q, scales, *, bits, group_size, transposed):
    """The logical ``[in, out]`` weight as the CUDA kernel forms it for bf16
    activations: int4 through ``magic_nibbles`` and one rounded bf16
    product, int8 through f32 and one rounding to bf16."""
    import torch

    axis = -1 if transposed else -2
    if bits == 4:
        lo, hi = magic_nibbles(q)
        w = torch.cat([lo, hi], dim=axis)
    else:
        w = q.float()
    in_f = w.shape[axis]
    s = _bf16_scales(scales)
    if group_size == in_f:
        s = s.transpose(-1, -2) if transposed else s
    else:
        s = s.repeat_interleave(group_size, dim=axis)
    w = bf16_rne(w * s)
    return w.transpose(-1, -2) if transposed else w


QMM_TILE_ROWS, QMM_WARPS, QMM_STEP = 16, 8, 64  # kTileRows, kWarps, kStep


def _mma_bf16_layout():
    """PTX's fragment layout of mma.m16n8k16 with bf16 operands, per lane
    (group g = lane // 4, thread t = lane % 4): A element i of 8 (register
    i // 2, half i % 2) at (row, col), B element i of 4 at (k, n), C
    register i of 4 at (row, col)."""
    lane = np.arange(32)[:, None]
    g, t = lane // 4, lane % 4
    i = np.arange(8)[None, :]
    r, e = i // 2, i % 2
    a_row = g + 8 * (r & 1)
    a_col = 2 * t + e + 8 * (r >> 1)
    i = np.arange(4)[None, :]
    b_k = 2 * t + i % 2 + 8 * (i // 2)
    b_n = np.broadcast_to(g, (32, 4))
    i = np.arange(4)[None, :]
    c_row = g + 8 * (i >> 1)
    c_col = 2 * t + (i & 1)
    return a_row, a_col, b_k, b_n, c_row, c_col


def _pair_inputs(bits, half):
    """Input offset of element e of pair p of lane thread t in a step (the
    k permutation): int4 word j = p // 4 gives lo 02, lo 13, hi 02, hi 13;
    int8 word j = p // 2 gives 02, 13. Returns [4, NP, 2] and the byte of
    each element within the 64-byte step and its nibble (0 lo, 1 hi)."""
    n_pairs = 16 if bits == 4 else 8
    inp = np.zeros((4, n_pairs, 2), np.int64)
    byte = np.zeros((4, n_pairs, 2), np.int64)
    nib = np.zeros((4, n_pairs, 2), np.int64)
    for t in range(4):
        for p in range(n_pairs):
            j, kind = (p // 4, p % 4) if bits == 4 else (p // 2, p % 2)
            for e in range(2):
                bt = 16 * t + 4 * j + (kind & 1) + 2 * e
                hi = bits == 4 and kind >= 2
                byte[t, p, e], nib[t, p, e] = bt, int(hi)
                inp[t, p, e] = bt + (half if hi else 0)
    return inp, byte, nib


def qmm_mma_emulate(x, q, scales, *, bits, group_size, fault=None, raw=False):
    """``[B, out]`` bf16 as qmm_mma (transposed q ``[out, k]``, bf16 x)
    computes it: per 16-row tile and 64-byte step, each lane's pairs of
    weight rows g and g + 8 and of x row g of each n-tile of 8 (rows >= B
    zero), through PTX's m16n8k16 fragment layout, f32 products; step s on
    warp s % 8, the warps' partials summed in warp order. ``raw`` returns the
    f32 totals. ``fault``: "swap_pair" feeds A its pairs 02 and 13 swapped
    (against unswapped x), "drop_step" leaves step 1 out."""
    import torch

    a_row, a_col, b_k, b_n, c_row, c_col = (torch.from_numpy(np.ascontiguousarray(m))
                                            for m in _mma_bf16_layout())
    b, in_f = x.shape
    out_f, k = q.shape
    half = in_f // 2
    nt = 1 if b <= 8 else 4
    steps = -(-k // QMM_STEP)
    tiles = -(-out_f // QMM_TILE_ROWS)
    inp, byte, nib = (torch.from_numpy(m) for m in _pair_inputs(bits, half))
    n_pairs = inp.shape[1]
    w = lean_dequant(q, scales, bits=bits, group_size=group_size, transposed=True)  # [in, out]
    # Column in_f is zero: what a lane past k (or a row past out or B) reads.
    wt = torch.zeros(tiles * QMM_TILE_ROWS, in_f + 1)
    xf = torch.zeros(8 * nt, in_f + 1)
    xf[:b, :in_f] = x.float()
    wt[:out_f, :in_f] = w.t()
    # Input index of each (step, t, pair, e).
    s_off = torch.arange(steps)[:, None, None, None] * QMM_STEP
    idx = torch.where(s_off + byte < k, s_off + byte + nib * half, in_f)
    pairs_w = wt.reshape(tiles, QMM_TILE_ROWS, -1)[:, :, idx]   # [tile, row, step, t, p, e]
    pairs_x = xf.reshape(nt, 8, -1)[:, :, idx]                  # [j, g, step, t, p, e]
    if fault == "swap_pair":
        pairs_w = pairs_w.reshape(*pairs_w.shape[:-2], n_pairs // 2, 2, 2).flip(-2).reshape(
            pairs_w.shape)
    acc = torch.zeros(tiles, nt, steps, 16, 8)
    for m in range(n_pairs // 2):
        # Lane (g, t): a0 = row g pair 2m, a1 = row g + 8 pair 2m, a2 = row g
        # pair 2m + 1, a3 = row g + 8 pair 2m + 1; b0, b1 = x row g pairs.
        regs = [pairs_w[:, :8, :, :, 2 * m], pairs_w[:, 8:, :, :, 2 * m],
                pairs_w[:, :8, :, :, 2 * m + 1], pairs_w[:, 8:, :, :, 2 * m + 1]]
        a_regs = torch.stack(regs, dim=-2).reshape(tiles, 8, steps, 4, 8)  # [tile,g,s,t,8]
        a_regs = a_regs.permute(0, 2, 1, 3, 4).reshape(tiles, steps, 32, 8)
        b_regs = torch.stack([pairs_x[..., 2 * m, :], pairs_x[..., 2 * m + 1, :]], dim=-2)
        b_regs = b_regs.reshape(nt, 8, steps, 4, 4).permute(0, 2, 1, 3, 4).reshape(
            nt, steps, 32, 4)
        a_mat = torch.zeros(tiles, steps, 16, 16)
        a_mat[:, :, a_row, a_col] = a_regs
        b_mat = torch.zeros(nt, steps, 16, 8)
        b_mat[:, :, b_k, b_n] = b_regs
        acc += torch.einsum("asmk,jskn->ajsmn", a_mat, b_mat)
    if fault == "drop_step" and steps > 1:
        acc[:, :, 1] = 0
    warps = torch.zeros(tiles, nt, QMM_WARPS, 16, 8)
    for s in range(steps):
        warps[:, :, s % QMM_WARPS] += acc[:, :, s]
    total = torch.zeros(tiles, nt, 16, 8)
    for wi in range(QMM_WARPS):
        total += warps[:, :, wi]
    # [tile, j, row, col] -> out[n = 8j + col, o = 16 tile + row]
    full = total.permute(1, 3, 0, 2).reshape(8 * nt, tiles * QMM_TILE_ROWS)[:b, :out_f]
    return full if raw else full.to(torch.bfloat16)


def _merge_splits(splits, fault):
    """The last block's sum of the blocks' partials, in split order."""
    import torch

    if len(splits) == 1:
        return splits[0]
    total = torch.zeros_like(splits[0])
    for sp, part in enumerate(splits):
        if not (fault == "drop_split" and sp == 1):
            total = total + part
    return total


def qmm_natural_emulate(x, q, scales, *, bits, group_size, sms=132, fault=None, raw=False):
    """``[B, out]`` as qmm_natural computes it (q ``[k, out]``, bf16 x), from
    the wrapper's plan: each block's packed rows cut into 8 contiguous warp
    runs, each thread's f32 sums row by row (lo, then hi), the warps' sums in
    warp order, the blocks' partials merged in split order. ``raw`` returns
    the f32 totals. ``fault``: "drop_split" leaves split 1 out of the merge;
    "swap_lo_hi" (int4) pairs each packed row's low nibble with x's high
    half and its high nibble with the low half."""
    import torch

    from metalchat_tpu_torch.ops.quant_matmul import NAT_WARPS, natural_plan

    b, in_f = x.shape
    k, out_f = q.shape
    half = in_f // 2
    _, n_split, per = natural_plan(b, k, out_f, sms)
    w = lean_dequant(q, scales, bits=bits, group_size=group_size, transposed=False)
    xf = x.float()
    xlo, xhi = (half, 0) if fault == "swap_lo_hi" else (0, half)
    splits = []
    for sp in range(n_split):
        r0, r1 = sp * per, min(k, (sp + 1) * per)
        per_warp = -(-(r1 - r0) // NAT_WARPS)
        red = torch.zeros(b, out_f)
        for wi in range(NAT_WARPS):
            acc = torch.zeros(b, out_f)
            for r in range(r0 + wi * per_warp, min(r1, r0 + (wi + 1) * per_warp)):
                if bits == 4:
                    acc = acc + xf[:, xlo + r:xlo + r + 1] * w[r][None, :]
                    acc = acc + xf[:, xhi + r:xhi + r + 1] * w[half + r][None, :]
                else:
                    acc = acc + xf[:, r:r + 1] * w[r][None, :]
            red = red + acc
        splits.append(red)
    total = _merge_splits(splits, fault)
    return total if raw else total.to(torch.bfloat16)
