"""Process-group initialisation (port of the JAX package's
``parallel/distributed.py`` ``initialize``).

The port's parallelism is multi-controller: one process per rank, every rank
running the same program in lockstep, joined by ``torch.distributed``
collectives. `initialize` sets up the default process group from its
arguments or from the standard environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``). It is idempotent and a no-op for one
process.

The backend is an explicit choice: ``nccl`` by default for the card, ``gloo``
for the CPU. Nothing switches it silently: a caller that wants gloo on the
card (two ranks on one card, which NCCL refuses) asks for it.

`make_hybrid_mesh` is the JAX package's DCN-aware mesh: dp across hosts,
tp inside one host. A "host" here is the group of ranks on one machine
(torchrun's ``LOCAL_WORLD_SIZE``), and ranks are numbered host by host, so
rank r sits at dp row ``r // tp`` and tp place ``r % tp``: the tp
collectives, the ones on every token's path, stay inside a machine.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.parallel.mesh import Mesh, make_mesh


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None,
               device=None, timeout_s: Optional[float] = None) -> bool:
    """Initialise ``torch.distributed``'s default process group.

    ``init_method`` is a rendezvous URL (``tcp://host:port`` or
    ``file:///path``); without one, ``MASTER_ADDR`` and ``MASTER_PORT`` must
    be set (``env://``). ``world_size`` and ``rank`` default to
    ``WORLD_SIZE`` and ``RANK``. ``backend`` defaults to ``nccl`` when
    ``device`` (default: the card) is a CUDA device and to ``gloo`` on the
    CPU. Returns whether a process group of more than one rank is up: False,
    with nothing done, for a single process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    if world_size is None or world_size == 1:
        return False
    if rank is None:
        raise ValueError(f"world_size={world_size} needs a rank (argument or RANK)")
    if init_method is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if not os.environ.get(v)]
        if missing:
            raise ValueError(f"no init_method and {', '.join(missing)} unset")
        init_method = "env://"
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return True


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()



def make_hybrid_mesh(dcn_dp: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """The ("dp", "tp") mesh with dp across hosts and tp inside one host (the
    JAX package's ``make_hybrid_mesh``) over the default process group.
    Weights are whole over dp and the batch splits over it. The defaults
    follow JAX's arithmetic with hosts for processes: ``dcn_dp`` the
    number of hosts, ``tp`` the ranks of one host (``LOCAL_WORLD_SIZE``,
    else every rank; at most the world over ``dcn_dp``). Without a process
    group up, a mesh of one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _env_int("LOCAL_WORLD_SIZE") or world
    dcn_dp = dcn_dp or max(1, world // local)
    per_dp = world // dcn_dp
    tp = tp or (per_dp // max(1, per_dp // local) or local)
    per_host_dp = world // (dcn_dp * tp)
    if dcn_dp * per_host_dp * tp != world:
        raise ValueError(f"dcn_dp={dcn_dp} × tp={tp} incompatible with {world} devices")
    return make_mesh(tp=tp, dp=dcn_dp * per_host_dp)
