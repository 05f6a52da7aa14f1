"""Generation loop, continuous-batching serving and its HTTP front end."""

from metalchat_tpu_torch.engine.generate import generate  # noqa: F401
from metalchat_tpu_torch.engine.paged import PageAllocator  # noqa: F401
from metalchat_tpu_torch.engine.serving import (  # noqa: F401
    Completion,
    ContinuousBatchingEngine,
    Request,
)

__all__ = ["Completion", "ContinuousBatchingEngine", "PageAllocator", "Request", "generate"]
