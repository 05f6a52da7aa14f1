"""Model families: prefill and the layer route (`transformer.forward`),
decode (`decode.decode_step`), projection fusion and the MoE FFN."""

from metalchat_tpu_torch.models.decode import decode_step  # noqa: F401
from metalchat_tpu_torch.models.fuse import fuse_projections  # noqa: F401
from metalchat_tpu_torch.models.transformer import (  # noqa: F401
    embed_tokens,
    forward,
    init_random_params,
    make_rope_tables,
)
