"""Generation loops, speculative decoding, continuous-batching serving and
its HTTP front end."""

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
from metalchat_tpu_torch.engine.speculative import (  # noqa: F401
    breakeven_accept_rate,
    measure_step_ratio,
    speculative_generate,
)

__all__ = ["Completion", "ContinuousBatchingEngine", "DecodeState", "PageAllocator",
           "Request", "breakeven_accept_rate", "generate", "generate_stream",
           "make_decode_step", "make_prefill", "measure_step_ratio", "speculative_generate"]
