"""GPTQ-style error-compensated rounding for per-channel quantization (port
of the JAX package's ``quant/gptq.py``).

Round-to-nearest quantizes every weight on its own; GPTQ (Frantar et al.,
2022, arXiv:2210.17323) quantizes input channels one after another and
folds each channel's rounding error into the channels not yet quantized,
weighted by the inverse Hessian of the layer's calibration activations
(H = XᵀX), which keeps the layer's output close to the dense model's. It
composes with the AWQ fold (`quant/awq.py`: fold first, then compensate)
and changes nothing at run time: the result is an ordinary per-channel
`QuantizedTensor` on the W4A8/W8A8 path.

Everything runs in f64 on the device of the weights: the damping, the
``act_order`` permutation, ``torch.linalg.inv`` and ``cholesky`` (batched
over layers), the rank-1 updates, the scale refit. The channels are visited
in the JAX package's order, and every channel's error is subtracted from
every later channel at once, ``w[i+1:] -= outer(u[i, i+1:], err)``, a
product and a difference each rounded as numpy rounds them: the JAX
package's arithmetic on every device. Each output column's recursion is
independent of the others, so the leaves that share a calibration tap
(wq/wk/wv, w1/w3) are rounded side by side as one wider matrix, all layers
at once (in chunks that bound the f64 Hessians' memory); nothing is read
back to the host inside the loop.

A failed factorization (a Hessian that damping does not make positive
definite) takes the identity factor, which is plain rounding: the JAX
package's behaviour. `gptq_quantize_params` counts such layers into the
``failures`` list a caller passes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.quant.quantize import QuantizedTensor, _pack_int4, auto_orient

# Which calibration tap (quant/awq.calibration_stats) feeds each target
# leaf: wq/wk/wv share the post-attention-norm activations, w1/w3 the
# post-FFN-norm ones.
_TAP_OF = {"wq": "qkv", "wk": "qkv", "wv": "qkv",
           "wo": "wo", "w1": "w13", "w3": "w13", "w2": "w2"}
# f64 Hessian bytes rounded together: the layers of one leaf are batched in
# chunks of at most this many bytes of Hessians (the factorization holds a
# few copies at once).
_CHUNK_BYTES = 2 << 30
# The clip-ratio grid of `_channel_scales`, f64 as numpy makes it.
_CLIP_RATIOS = [float(r) for r in np.linspace(1.0, 0.5, 11)]


def hessian_tap(h: torch.Tensor) -> torch.Tensor:
    """Second-moment tap for `calibration_stats`: H = XᵀX over (batch,
    sequence), an f32 product, then f64."""
    flat = h.float().reshape(-1, h.shape[-1])
    return (flat.T @ flat).double()


def _channel_scales(w: torch.Tensor, qmax: float, clip_search: bool) -> torch.Tensor:
    """Per-output-channel symmetric scales ``[..., out]`` (f64) of w ``[...,
    in, out]``: absmax, or the clip ratio with the least squared error."""
    scales = w.abs().amax(dim=-2) / qmax
    if not clip_search:
        return scales
    best_err = torch.full_like(scales, float("inf"))
    best = scales.clone()
    for ratio in _CLIP_RATIOS:
        s = scales * ratio
        inv = torch.where(s == 0.0, 0.0, 1.0 / s)
        q = torch.clamp(torch.round(w * inv[..., None, :]), -qmax, qmax)
        err = ((q * s[..., None, :] - w) ** 2).sum(dim=-2)
        best = torch.where(err < best_err, s, best)
        best_err = torch.minimum(err, best_err)
    return best


class _Factor:
    """A Hessian made ready for the recursion: the dead channels (zero
    diagonal), the ``act_order`` permutation (or None), the upper factor U
    of the damped H⁻¹ (H⁻¹ = UᵀU) in permuted order, and whether the
    factorization failed (then U is the identity)."""

    def __init__(self, hessian: torch.Tensor, *, act_order: bool, damp: float):
        H = hessian.double().clone()
        n = H.shape[-1]
        diag = H.diagonal(dim1=-2, dim2=-1)
        self.dead = diag <= 0
        diag.copy_(torch.where(self.dead, 1.0, diag))
        self.perm = None
        if act_order:
            self.perm = torch.argsort(-H.diagonal(dim1=-2, dim2=-1), dim=-1, stable=True)
            H = torch.take_along_dim(H, self.perm[..., :, None], dim=-2)
            H = torch.take_along_dim(H, self.perm[..., None, :], dim=-1)
        diag = H.diagonal(dim1=-2, dim2=-1)
        diag.add_(damp * diag.mean(dim=-1, keepdim=True))
        if H.device.type == "cpu":
            # torch's CPU build with MKL 2024.2 never returns from a batched
            # f64 inverse of 1024-wide matrices on more than one thread; one
            # matrix at a time it does (on one thread with the batched
            # call's bits).
            pairs = [torch.linalg.inv_ex(h) for h in H.reshape(-1, n, n)]
            hinv = torch.stack([p[0] for p in pairs]).reshape(H.shape)
            info_inv = torch.stack([p[1] for p in pairs]).reshape(H.shape[:-2])
        else:
            hinv, info_inv = torch.linalg.inv_ex(H)
        del H
        lower, info_chol = torch.linalg.cholesky_ex(hinv)
        del hinv
        self.failed = (info_inv != 0) | (info_chol != 0)
        eye = torch.eye(n, dtype=torch.float64, device=lower.device)
        self.u = torch.where(self.failed[..., None, None], eye, lower.transpose(-1, -2))


def _round(w: torch.Tensor, scales: torch.Tensor, factor: _Factor, *,
           qmax: float) -> torch.Tensor:
    """Compensated rounding of w ``[..., in, out]`` (f64) on a factored
    Hessian: int8 codes on the ±qmax grid, in w's channel order."""
    w = torch.where(factor.dead[..., :, None], 0.0, w)
    if factor.perm is not None:
        w = torch.take_along_dim(w, factor.perm[..., :, None], dim=-2)
    u = factor.u
    inv_s = torch.where(scales == 0.0, 0.0, 1.0 / scales)[..., None, :]
    s = scales[..., None, :]
    n = w.shape[-2]
    codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for i in range(n):
        wi = w[..., i:i + 1, :]
        q = torch.clamp(torch.round(wi * inv_s), -qmax, qmax)
        codes[..., i:i + 1, :] = q
        err = (wi - q * s) / u[..., i:i + 1, i:i + 1]
        if i + 1 < n:
            w[..., i + 1:, :] -= u[..., i, i + 1:, None] * err
    if factor.perm is not None:
        codes = torch.empty_like(codes).scatter_(
            -2, factor.perm[..., :, None].expand_as(codes), codes)
    return codes


def gptq_rounding(w, scales, hessian, *, qmax: float, act_order: bool = True,
                  damp: float = 0.01,
                  failures: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Sequential compensated rounding; int8 codes on the ±qmax grid.

    The classic GPTQ recursion with the upper Cholesky factor U of H⁻¹:
    channel i rounds, its scaled error ``err = (w_i - q_i·s) / U[i,i]``
    propagates into channels j > i as ``w_j -= U[i,j]·err``. ``act_order``
    visits channels by decreasing Hessian diagonal. w ``[(B,) in, out]``,
    scales ``[(B,) out]``, hessian ``[(B,) in, in]``: a leading batch axis
    rounds several matrices at once. ``failures``: see the module
    docstring."""
    w = torch.as_tensor(w).double()
    factor = _Factor(torch.as_tensor(hessian, device=w.device), act_order=act_order, damp=damp)
    if failures is not None:
        failures.append(factor.failed)
    return _round(w, torch.as_tensor(scales, device=w.device).double(), factor, qmax=qmax)


def _refit_scales(w: torch.Tensor, q: torch.Tensor, hessian: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """Least-squares per-channel scales under the calibration Hessian: for
    fixed codes q the error (w_c - s·q_c)ᵀH(w_c - s·q_c) is least at
    s* = q_cᵀHw_c / q_cᵀHq_c; a degenerate channel keeps its scale."""
    num = (q * (hessian @ w)).sum(dim=-2)
    den = (q * (hessian @ q)).sum(dim=-2)
    good = den > 0
    out = torch.where(good, num / torch.where(good, den, 1.0), scales)
    return torch.where(out > 0, out, scales)


def _gptq_codes(w: torch.Tensor, hessian: torch.Tensor, *, qmax: float, clip_search: bool,
                act_order: bool, damp: float, refit_iters: int,
                failures: Optional[List[torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes ``[..., in, out]``, f64 scales ``[..., out]``) of w (f64):
    compensated rounding, then ``refit_iters`` rounds of refit → re-round,
    each channel keeping the candidate with the least Hessian objective
    (never worse than the first round → refit)."""
    H = hessian.double()
    scales = _channel_scales(w, qmax, clip_search)
    factor = _Factor(H, act_order=act_order, damp=damp)
    if failures is not None:
        failures.append(factor.failed)
    q = _round(w, scales, factor, qmax=qmax)
    if not refit_iters:
        return q, scales

    def channel_obj(qf, s):
        e = w - qf * s[..., None, :]
        return (e * (H @ e)).sum(dim=-2)

    scales = _refit_scales(w, q.double(), H, scales)
    best_q, best_s = q, scales
    best_obj = channel_obj(q.double(), scales)
    for _ in range(refit_iters):
        q = _round(w, scales, factor, qmax=qmax)
        scales = _refit_scales(w, q.double(), H, scales)
        obj = channel_obj(q.double(), scales)
        take = obj < best_obj
        best_q = torch.where(take[..., None, :], q, best_q)
        best_s = torch.where(take, scales, best_s)
        best_obj = torch.minimum(obj, best_obj)
    return best_q, best_s


def _per_channel(q: torch.Tensor, scales: torch.Tensor, bits: int, act_bits: Optional[int],
                 scales_dtype) -> QuantizedTensor:
    """Codes ``[(L,) in, out]`` and f64 scales ``[(L,) out]`` → a per-channel
    `QuantizedTensor` in `auto_orient`'s storage."""
    in_features = q.shape[-2]
    return auto_orient(QuantizedTensor(
        q=_pack_int4(q) if bits == 4 else q, scales=scales[..., None, :].to(scales_dtype),
        bits=bits, group_size=in_features, transposed=False, act_bits=act_bits))


def gptq_quantize(w, hessian, *, bits: int = 4, act_bits: Optional[int] = 8,
                  clip_search: bool = True, act_order: bool = True, damp: float = 0.01,
                  refit_iters: int = 0, scales_dtype=torch.float32,
                  failures: Optional[List[torch.Tensor]] = None) -> QuantizedTensor:
    """GPTQ-quantize an ``[(L,) in, out]`` weight to a per-channel
    `QuantizedTensor` (a drop-in for ``quantize(..., group_size=None)``).

    ``refit_iters > 0`` alternates compensated rounding with the Hessian
    least-squares scale refit; every (codes, scales) candidate is scored per
    output channel on (w_c − s·q_c)ᵀH(w_c − s·q_c) and the best ships."""
    w = torch.as_tensor(w).float().double()
    q, scales = _gptq_codes(w, torch.as_tensor(hessian, device=w.device),
                            qmax=127.0 if bits == 8 else 7.0, clip_search=clip_search,
                            act_order=act_order, damp=damp, refit_iters=refit_iters,
                            failures=failures)
    return _per_channel(q, scales, bits, act_bits, scales_dtype)


def _chunks(n_layers: int, n: int) -> List[slice]:
    per = max(1, _CHUNK_BYTES // (8 * n * n))
    return [slice(i, min(i + per, n_layers)) for i in range(0, n_layers, per)]


@torch.no_grad()
def gptq_quantize_params(params: Dict[str, Any], config: ModelConfig, calibration_tokens, *,
                         bits: int = 4, act_bits: Optional[int] = 8,
                         awq_alpha: Optional[float] = None, clip_search: bool = True,
                         act_order: bool = True, damp: float = 0.01, refit_iters: int = 0,
                         targets: Sequence[str] = ("wq", "wk", "wv", "wo", "w1", "w2", "w3"),
                         failures: Optional[List[torch.Tensor]] = None) -> Dict[str, Any]:
    """Calibrate → (optional AWQ fold) → GPTQ-quantize the target leaves.

    ``awq_alpha`` folds the AWQ saliency scales first (exact), then the
    Hessians are collected on the folded model, so the compensation matches
    the weights being rounded. Scales are f32 ``[L, 1, out]``, as in the JAX
    package. ``failures`` (a list) receives one bool tensor a layer chunk:
    the layers whose factorization fell back to plain rounding."""
    from metalchat_tpu_torch.quant.awq import awq_fold, calibration_stats

    if awq_alpha is not None:
        stats = calibration_stats(params, config, calibration_tokens)
        params = awq_fold(params, config, stats, alpha=awq_alpha)
    hess = calibration_stats(params, config, calibration_tokens, tap=hessian_tap)

    layers = dict(params["layers"])
    qmax = 127.0 if bits == 8 else 7.0
    for tap in dict.fromkeys(_TAP_OF[n] for n in targets if n in layers):
        names = [n for n in targets if n in layers and _TAP_OF[n] == tap]
        widths = [layers[n].shape[-1] for n in names]
        w = torch.cat([layers[n].float() for n in names], dim=-1)
        H = hess[tap]
        parts = [_gptq_codes(w[c].double(), H[c].to(w.device), qmax=qmax,
                             clip_search=clip_search, act_order=act_order, damp=damp,
                             refit_iters=refit_iters, failures=failures)
                 for c in _chunks(w.shape[0], w.shape[-2])]
        del w
        q = torch.cat([p[0] for p in parts])
        scales = torch.cat([p[1] for p in parts])
        for name, qn, sn in zip(names, q.split(widths, dim=-1), scales.split(widths, dim=-1)):
            layers[name] = _per_channel(qn.contiguous(), sn, bits, act_bits, torch.float32)
    out = dict(params)
    out["layers"] = layers
    return out
