"""Train-state files for resuming a fine-tune: the trainable leaves, the
optimizer's state and the step (port of the JAX package's
``train/checkpoint.py``, the same layout).

Only leaves reach the file, as safetensors ``leaf.{i}`` with ``n_leaves``
in the metadata, in the JAX package's order: the trainable list, then the
optimizer state in optax's layout (`convert.optimizer_state_leaves`), then
the step. Restoring goes through a template state made by
``make_train_step(...)[0]`` on the same model and optimizer, so files
cross between the two packages both ways.

A sharded state (``make_train_step(..., mesh=)``) writes the whole state's
file, the JAX package's for the same training on one device: every rank
gathers (`train.step.gather_train_state`), the mesh's rank 0 writes, and
the ranks wait for it. Loaded into a sharded template, a file is cut into
each rank's part again (`parallel.mesh.shard_leaf`: an expert stack over
ep and tp).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from metalchat_tpu_torch.convert import optimizer_state_leaves, set_optimizer_state
from metalchat_tpu_torch.io.safetensors import open_safetensors, save_safetensors
from metalchat_tpu_torch.parallel.mesh import shard_leaf
from metalchat_tpu_torch.train.step import TrainState, gather_train_state, moment_paths


def _leaves(state: TrainState) -> list:
    return [*state.trainable, *optimizer_state_leaves(state.opt_state, state.trainable),
            state.step]


def save_train_state(path: str, state: TrainState) -> None:
    lay = state.layout
    if lay is not None:  # every rank gathers; the mesh's rank 0 writes
        whole = gather_train_state(state)
        if lay.mesh.grid.rank == 0:
            save_train_state(path, whole)
        if dist.is_initialized():
            dist.barrier(group=lay.mesh.grid.group)
        return
    leaves = _leaves(state)
    save_safetensors(path, {f"leaf.{i}": leaf for i, leaf in enumerate(leaves)},
                     metadata={"n_leaves": str(len(leaves))})


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into ``template`` (same model and optimizer): its leaves are
    overwritten in place and its optimizer's state replaced. A sharded
    template takes its rank's part of each whole leaf and moment."""
    doc = open_safetensors(path)
    n = int(doc.metadata["n_leaves"])
    want = _leaves(template)
    if len(want) != n:
        raise ValueError(f"checkpoint has {n} leaves, template has {len(want)} "
                         "(different model or optimizer)")
    k = len(template.trainable)
    lay = template.layout
    paths = [None] * n if lay is None else \
        [*lay.paths, *moment_paths(n - k - 1, lay.paths), None]

    def leaf(i):
        t = doc.torch_tensor(f"leaf.{i}")
        if paths[i] is not None:
            t = shard_leaf(t, paths[i], lay.config, lay.mesh)
        # 0-d leaves may have been stored as [1]
        return t.reshape(want[i].shape).to(want[i].dtype)

    leaves = [leaf(i) for i in range(n)]
    with torch.no_grad():
        for t, x in zip(template.trainable, leaves[:k]):
            t.copy_(x)
    set_optimizer_state(template.opt_state, template.trainable, leaves[k:-1])
    return TrainState(template.trainable, template.opt_state, leaves[-1], lay)
