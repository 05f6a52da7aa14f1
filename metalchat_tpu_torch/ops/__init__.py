"""Op layer: plain PyTorch reference ops and the hand-written CUDA kernels.

Each kernel wrapper dispatches on its tensors' device: CPU tensors take the
kernel's plain PyTorch version (the oracle the kernel is held against),
CUDA tensors launch the kernel, and anything else raises. There is no
fallback from the kernel to the plain version and no switch to force one.

| kernel (``csrc/``)       | wrapper                                       | TPU kernel it replaces |
| ``a8_matvec.cu``         | ``quant_matvec_stacked_fused`` / ``_stacked`` (the fused call first runs ``quantize_rows``, kernel ``a8_quantize``; its stack entry an int, or a 0-d int32 tensor on the card that the kernel reads) | ``ops/a8_matvec_pallas.py`` |
| ``decode_attention.cu``  | ``decode_attention_update_quantized_stacked`` (write mode), ``decode_attention_stacked`` / ``decode_attention_quantized_stacked`` (read-only; the module's ``decode_attention`` / ``decode_attention_quantized`` take one layer) | ``ops/decode_attention_pallas.py`` |
| ``flash_attention.cu``   | ``flash_attention``                           | ``ops/flash_attention_pallas.py`` |
| ``paged_attention.cu``   | ``paged_decode_attention_update_stacked`` (write mode), ``paged_decode_attention_stacked`` / ``paged_decode_attention`` (read-only) | ``ops/paged_attention_pallas.py`` |
| ``quant_matmul.cu``      | ``dequant_matmul`` (weight-only int8/int4, group or per-channel scales, ≤ 32 rows) | ``ops/quant_matmul_pallas.py`` |
| ``ffn_block.cu``         | ``ffn_block_stacked`` (wo → residual → norm → w13 → act → w2 → residual, one cooperative launch) | ``ops/ffn_block_pallas.py`` |
"""

from __future__ import annotations

from typing import Dict

from metalchat_tpu_torch.ops._build import LAUNCHES, build_all, reset_launch_counts
from metalchat_tpu_torch.ops.a8_matvec import (  # noqa: F401
    quant_matvec_stacked,
    quant_matvec_stacked_fused,
)
from metalchat_tpu_torch.ops.decode_attention import (  # noqa: F401
    decode_attention_quantized_stacked,
    decode_attention_stacked,
    decode_attention_update_quantized_stacked,
)
from metalchat_tpu_torch.ops.ffn_block import ffn_block_stacked  # noqa: F401
from metalchat_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
from metalchat_tpu_torch.ops.paged_attention import (  # noqa: F401
    paged_decode_attention,
    paged_decode_attention_stacked,
    paged_decode_attention_update_stacked,
)
from metalchat_tpu_torch.ops.quant_matmul import dequant_matmul  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts` (plain-version
    calls on CPU tensors are not launches and are not counted)."""
    return dict(LAUNCHES)


__all__ = [
    "build_all", "decode_attention_quantized_stacked", "decode_attention_stacked",
    "decode_attention_update_quantized_stacked", "dequant_matmul", "ffn_block_stacked",
    "flash_attention",
    "launch_counts", "paged_decode_attention", "paged_decode_attention_stacked",
    "paged_decode_attention_update_stacked", "quant_matvec_stacked",
    "quant_matvec_stacked_fused", "reset_launch_counts",
]
