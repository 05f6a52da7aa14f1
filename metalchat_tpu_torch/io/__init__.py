"""Checkpoint reading: safetensors documents and the HF (Llama, Gemma-3,
Mixtral, GPT-2) and Meta loaders."""

from metalchat_tpu_torch.io.loaders import (  # noqa: F401
    load_gpt2_params,
    load_params,
    save_params,
)
from metalchat_tpu_torch.io.safetensors import (  # noqa: F401
    SafetensorsDocument,
    open_safetensors,
    save_safetensors,
    save_sharded_safetensors,
)
