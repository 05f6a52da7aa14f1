"""Quantization: packed weights, the W4A8/W8A8 and weight-only linears,
row-quantized embeddings, and perplexity (`ppl`) to score them. The
function ``quantize`` stays under its module's name,
``metalchat_tpu_torch.quant.quantize``, which it would shadow here."""

from metalchat_tpu_torch.quant.quantize import (  # noqa: F401
    QuantizedTensor,
    dequantize,
    linear,
    lookup_embedding,
    quant_matmul,
    quantize_params,
)
from metalchat_tpu_torch.quant.ppl import (  # noqa: F401
    perplexity,
    perplexity_delta,
    token_nll,
)
