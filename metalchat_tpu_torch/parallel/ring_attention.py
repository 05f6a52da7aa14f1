"""Ring attention: attention over a sequence split across a mesh axis (port
of the JAX package's ``parallel/ring_attention.py``).

Each rank holds one block of queries and one block of keys and values. It
attends its queries to the block it holds, then passes the block to the
next rank of the ring and takes the previous rank's (`GridMesh.shift`,
JAX's ``ppermute``), until every query has seen every block; the online
softmax statistics (m, l), kept in f32, make the blockwise sum exact up to
rounding. The products are plain PyTorch: in the JAX package they are XLA
einsums, not a Pallas kernel. The K/V pair of a block travels as one tensor,
one transfer a rotation.
"""

from __future__ import annotations

import torch

from metalchat_tpu_torch.parallel.mesh import GridMesh

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


def _block_attention(q, k, v, q_pos, kv_pos, scale: float):
    """Partial attention of q ``[B, S, nh, hd]`` against one block k/v
    ``[B, nkv, T, hd]`` (query head h reads kv-head h // (nh / nkv)) at
    global positions ``q_pos [S]`` and ``kv_pos [T]``: f32 (acc ``[B, S, nh,
    hd]``, m and l ``[B, S, nh, 1]``). The products take their operands in
    f32 (JAX's ``preferred_element_type``)."""
    b, s, nh, hd = q.shape
    nkv = k.shape[1]
    qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) * scale
    mask = kv_pos[None, :] <= q_pos[:, None]                       # [S, T]
    scores = torch.where(mask, scores, torch.tensor(MASK_VALUE, device=scores.device))
    m = scores.amax(dim=-1, keepdim=True)                         # [b, kv, g, s, 1]
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bktd->bkgsd", p, v.float())

    def heads(t):  # [b, kv, g, s, d] → [b, s, nh, d]
        return t.permute(0, 3, 1, 2, 4).reshape(b, s, nh, t.shape[-1])

    return heads(acc), heads(m), heads(l)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: GridMesh, *,
                   scale: float, causal: bool = True, axis: str = "sp") -> torch.Tensor:
    """Attention of this rank's queries q ``[B, S_loc, nh, hd]`` (block
    ``index(axis)`` of the sequence) over every rank's block k/v ``[B, nkv,
    T_loc, hd]``, in q's dtype. Causal over global positions, or, with
    ``causal=False``, over every position. Every rank of ``axis`` calls it
    together; the blocks take ``size(axis) - 1`` rotations."""
    n, idx = mesh.size(axis), mesh.index(axis)
    b, s_loc, nh, hd = q.shape
    t_loc = k.shape[2]
    dev = q.device
    if causal:
        q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    else:
        q_pos = torch.full((s_loc,), torch.iinfo(torch.int32).max, device=dev)
    acc = torch.zeros((b, s_loc, nh, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, s_loc, nh, 1), float("-inf"), device=dev)
    l = torch.zeros((b, s_loc, nh, 1), dtype=torch.float32, device=dev)
    block = torch.stack([k, v])
    for step in range(n):
        src = (idx - step) % n  # the rank this block started on
        kv_pos = src * t_loc + torch.arange(t_loc, device=dev)
        blk_acc, blk_m, blk_l = _block_attention(q, block[0], block[1], q_pos, kv_pos, scale)
        m_next = torch.maximum(m, blk_m)
        alpha, beta = torch.exp(m - m_next), torch.exp(blk_m - m_next)
        acc = acc * alpha + blk_acc * beta
        l = l * alpha + blk_l * beta
        m = m_next
        if step + 1 < n:
            block = mesh.shift(block, axis, wrap=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mesh: GridMesh, axis: str = "sp", *, scale: float,
                               causal: bool = True) -> torch.Tensor:
    """`ring_attention` over whole tensors (the JAX package's ``shard_map``
    wrapper): q ``[B, S, nh, hd]`` and k/v ``[B, nkv, S, hd]`` the same on
    every rank of ``axis``; each rank takes its block of the sequence (S
    divisible by the axis size) and the output ``[B, S, nh, hd]`` is
    gathered whole on every rank."""
    n, idx = mesh.size(axis), mesh.index(axis)
    if q.shape[1] % n or k.shape[2] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by {axis}={n}")
    s_loc, t_loc = q.shape[1] // n, k.shape[2] // n
    out = ring_attention(q[:, idx * s_loc:(idx + 1) * s_loc].contiguous(),
                         k[:, :, idx * t_loc:(idx + 1) * t_loc].contiguous(),
                         v[:, :, idx * t_loc:(idx + 1) * t_loc].contiguous(),
                         mesh, scale=scale, causal=causal, axis=axis)
    return mesh.all_gather(out, axis, dim=1)
