"""Fine-tuning: full-parameter and (Q)LoRA training on the model core
(port of the JAX package's ``train/``).

The train step differentiates the same `models.transformer.forward` used
for serving, on its differentiable route (no kernel; per-layer
rematerialization with ``torch.utils.checkpoint``), with a PyTorch
optimizer, and the trained adaptors go back to serving through
`quant/checkpoint.py` and the engines. On a (dp, tp) mesh the step runs
one process a rank (``make_train_step(..., mesh=)``), and
``gather_train_state`` puts the trained state back together.
"""

from metalchat_tpu_torch.train.checkpoint import load_train_state, save_train_state
from metalchat_tpu_torch.train.data import PackedDataset, from_texts
from metalchat_tpu_torch.train.lora import attach_lora, lora_param_count, merge_lora
from metalchat_tpu_torch.train.step import (
    TrainLayout,
    TrainState,
    causal_lm_loss,
    combine,
    gather_train_state,
    make_train_step,
    partition,
    trainable_full,
    trainable_lora,
)

__all__ = [
    "attach_lora",
    "merge_lora",
    "lora_param_count",
    "TrainState",
    "TrainLayout",
    "gather_train_state",
    "causal_lm_loss",
    "make_train_step",
    "partition",
    "combine",
    "trainable_lora",
    "trainable_full",
    "PackedDataset",
    "from_texts",
    "save_train_state",
    "load_train_state",
]
