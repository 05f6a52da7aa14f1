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
