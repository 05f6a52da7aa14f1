"""Train-state files for resuming a fine-tune: the trainable leaves, the
optimizer's state and the step (port of the JAX package's
``train/checkpoint.py``, the same layout).

Only leaves reach the file, as safetensors ``leaf.{i}`` with ``n_leaves``
in the metadata, in the JAX package's order: the trainable list, then the
optimizer state in optax's layout (`convert.optimizer_state_leaves`), then
the step. Restoring goes through a template state made by
``make_train_step(...)[0]`` on the same model and optimizer, so files
cross between the two packages both ways.
"""

from __future__ import annotations

import torch

from metalchat_tpu_torch.convert import optimizer_state_leaves, set_optimizer_state
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from metalchat_tpu_torch.train.step import TrainState


def _leaves(state: TrainState) -> list:
    return [*state.trainable, *optimizer_state_leaves(state.opt_state, state.trainable),
            state.step]


def save_train_state(path: str, state: TrainState) -> None:
    leaves = _leaves(state)
    save_safetensors(path, {f"leaf.{i}": leaf for i, leaf in enumerate(leaves)},
                     metadata={"n_leaves": str(len(leaves))})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into ``template`` (same model and optimizer): its leaves are
    overwritten in place and its optimizer's state replaced."""
    doc = open_safetensors(path)
    n = int(doc.metadata["n_leaves"])
    want = _leaves(template)
    if len(want) != n:
        raise ValueError(f"checkpoint has {n} leaves, template has {len(want)} "
                         "(different model or optimizer)")
    # 0-d leaves may have been stored as [1]
    leaves = [doc.torch_tensor(f"leaf.{i}").reshape(want[i].shape).to(want[i].dtype)
              for i in range(n)]
    k = len(template.trainable)
    with torch.no_grad():
        for t, leaf in zip(template.trainable, leaves[:k]):
            t.copy_(leaf)
    set_optimizer_state(template.opt_state, template.trainable, leaves[k:-1])
    return TrainState(template.trainable, template.opt_state, leaves[-1])
