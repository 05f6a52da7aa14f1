"""Chat layer: templates, token scanners, tool calling, the interpreter."""

from metalchat_tpu_torch.chat.template import render_template  # noqa: F401
from metalchat_tpu_torch.chat.scanners import (  # noqa: F401
    CompositeScanner,
    LimitScanner,
    StopTokenScanner,
)
from metalchat_tpu_torch.chat.tools import Command, CommandScanner, CommandStatement  # noqa: F401
from metalchat_tpu_torch.chat.interpreter import ChatSession, ChatTemplates, Interpreter  # noqa: F401
from metalchat_tpu_torch.chat.hf_template import (  # noqa: F401,E402
    load_chat_template,
    render_chat_template,
)
