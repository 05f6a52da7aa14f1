"""Parallelism over ``torch.distributed`` (port of the JAX package's
``parallel/``): ``distributed``, ``mesh`` (its tp axis, and `GridMesh`
for the pipeline's ("dp", "pp") and context parallelism's ("sp",) grids),
``tp_decode``, ``multihost``'s engine, ``pipeline``, ``context`` and
``ring_attention``. One process runs per rank and every rank runs the same
program in lockstep; the dp axis of the tp mesh, ``make_hybrid_mesh`` and
``MultiHostServer`` are not ported yet."""

from metalchat_tpu_torch.parallel.context import context_parallel_prefill  # noqa: F401
from metalchat_tpu_torch.parallel.distributed import initialize, shutdown  # noqa: F401
from metalchat_tpu_torch.parallel.mesh import (  # noqa: F401
    GridMesh,
    Mesh,
    make_grid_mesh,
    make_mesh,
    shard_cache,
    shard_params,
)
from metalchat_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostEngine,
    MultiHostRoundError,
)
from metalchat_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_forward,
    make_pp_mesh,
    shard_cache_pp,
    shard_params_pp,
)
from metalchat_tpu_torch.parallel.tp_decode import (  # noqa: F401
    make_tp_decode_step,
    supports_tp_fast_decode,
    tp_decode_forward_fn,
    tp_refusal,
)
