"""Quantization: packed weights, the W4A8/W8A8 and weight-only linears,
LoRA adaptors (`LoraLinear`), row-quantized embeddings, perplexity (`ppl`)
to score them, the calibrated schemes (`awq`, `gptq`) and the quantized
checkpoints (`checkpoint`: the native dialect and the reference's QLoRA
one). The function ``quantize`` stays under its module's name,
``metalchat_tpu_torch.quant.quantize``, which it would shadow here."""

from metalchat_tpu_torch.quant.quantize import (  # noqa: F401
    LoraLinear,
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
