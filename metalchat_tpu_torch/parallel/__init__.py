"""Parallelism over ``torch.distributed`` (port of the JAX package's
``parallel/``): ``distributed`` (``initialize``, ``make_hybrid_mesh``),
``mesh`` (the ("dp", "ep", "tp") mesh and its sharding rules, and
`GridMesh` for the pipeline's ("dp", "pp") and context parallelism's
("sp",) grids), ``tp_decode``, ``multihost`` (``MultiHostServer``,
``MultiHostEngine``), ``pipeline``, ``context`` and ``ring_attention``. One
process runs per rank and every rank runs the same program in lockstep.
The names the JAX package's ``parallel/__init__.py`` exports are here, and
beside them the port's own entry points of those modules."""

from metalchat_tpu_torch.parallel.context import context_parallel_prefill  # noqa: F401
from metalchat_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize,
    make_hybrid_mesh,
    shutdown,
)
from metalchat_tpu_torch.parallel.mesh import (  # noqa: F401
    DifferentiableMesh,
    GridMesh,
    Mesh,
    gather_leaf,
    leaf_ep_axis,
    leaf_tp_axis,
    make_grid_mesh,
    make_mesh,
    shard_cache,
    shard_leaf,
    shard_params,
)
from metalchat_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostEngine,
    MultiHostRoundError,
    MultiHostServer,
)
from metalchat_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_forward,
    make_pp_mesh,
    shard_cache_pp,
    shard_params_pp,
)
from metalchat_tpu_torch.parallel.tp_decode import (  # noqa: F401
    layer_route_forward_fn,
    layer_route_refusal,
    make_tp_decode_step,
    rank_kv_heads,
    spmd_forward_fn,
    supports_tp_fast_decode,
    tp_decode_forward_fn,
    tp_refusal,
)
