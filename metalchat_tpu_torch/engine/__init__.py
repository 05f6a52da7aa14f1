"""Generation loops, continuous-batching serving and its HTTP front end."""

from metalchat_tpu_torch.engine.generate import (  # noqa: F401
    DecodeState,
    generate,
    generate_stream,
    make_decode_step,
    make_prefill,
)
from metalchat_tpu_torch.engine.paged import PageAllocator  # noqa: F401
from metalchat_tpu_torch.engine.serving import (  # noqa: F401
    Completion,
    ContinuousBatchingEngine,
    Request,
)

__all__ = ["Completion", "ContinuousBatchingEngine", "DecodeState", "PageAllocator",
           "Request", "generate", "generate_stream", "make_decode_step", "make_prefill"]
