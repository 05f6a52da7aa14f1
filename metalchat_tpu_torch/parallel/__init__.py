"""Tensor parallelism over ``torch.distributed`` (port of the JAX package's
``parallel/``: ``distributed``, ``mesh`` on its tp axis, ``tp_decode`` and
``multihost``'s engine). One process runs per rank and every rank runs the
same program in lockstep; the pipeline, context-parallel and ring-attention
modules, the dp axis and ``MultiHostServer`` are not ported yet."""

from metalchat_tpu_torch.parallel.distributed import initialize, shutdown  # noqa: F401
from metalchat_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_cache,
    shard_params,
)
from metalchat_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostEngine,
    MultiHostRoundError,
)
from metalchat_tpu_torch.parallel.tp_decode import (  # noqa: F401
    make_tp_decode_step,
    supports_tp_fast_decode,
    tp_decode_forward_fn,
    tp_refusal,
)
