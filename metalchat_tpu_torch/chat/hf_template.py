"""HuggingFace `chat_template` (Jinja2) rendering (port of the JAX
package's ``chat/hf_template.py``).

Each HF checkpoint ships a Jinja2 ``chat_template`` in
``tokenizer_config.json``; rendering the conversation through it serves
models whose prompt format the built-in mustache templates do not cover.
``jinja2`` is imported inside `render_chat_template` only, so a machine
without it runs every other chat path; a checkpoint with a template raises
`ImportError` there.

The HF template surface: ``messages`` / ``tools`` / ``add_generation_prompt``
/ ``bos_token`` / ``eos_token`` variables, the ``tojson`` filter,
``raise_exception`` and ``strftime_now``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Sequence


class TemplateError(ValueError):
    pass


def load_chat_template(model_dir: str | Path) -> Optional[str]:
    """Read `chat_template` from tokenizer_config.json (None if absent).

    Handles both the plain-string form and the named-list form
    ([{"name": "default", "template": ...}, ...]).
    """
    path = Path(model_dir) / "tokenizer_config.json"
    if not path.exists():
        return None
    cfg = json.loads(path.read_text())
    tpl = cfg.get("chat_template")
    if tpl is None:
        return None
    if isinstance(tpl, list):
        by_name = {t.get("name"): t.get("template") for t in tpl}
        return by_name.get("default") or next(iter(by_name.values()), None)
    return tpl


def render_chat_template(
    template: str,
    messages: Sequence[Mapping[str, Any]],
    *,
    add_generation_prompt: bool = True,
    tools: Optional[Iterable[Mapping[str, Any]]] = None,
    bos_token: str = "",
    eos_token: str = "",
    **extra: Any,
) -> str:
    """Render a conversation through an HF Jinja2 chat template."""
    import jinja2

    def raise_exception(message: str):
        raise TemplateError(message)

    def strftime_now(fmt: str) -> str:
        import datetime

        return datetime.datetime.now().strftime(fmt)

    env = jinja2.Environment(
        loader=jinja2.BaseLoader(),
        trim_blocks=True,
        lstrip_blocks=True,
        undefined=jinja2.StrictUndefined,
        extensions=["jinja2.ext.loopcontrols"],
    )
    env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now

    try:
        compiled = env.from_string(template)
        return compiled.render(
            messages=list(messages),
            tools=list(tools) if tools else None,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos_token,
            eos_token=eos_token,
            **extra,
        )
    except jinja2.exceptions.UndefinedError:
        # Templates probe optional vars; retry leniently.
        env.undefined = jinja2.Undefined
        compiled = env.from_string(template)
        return compiled.render(
            messages=list(messages),
            tools=list(tools) if tools else None,
            add_generation_prompt=add_generation_prompt,
            bos_token=bos_token,
            eos_token=eos_token,
            **extra,
        )


class HFChatTemplates:
    """Incremental adapter: drive the Interpreter's persistent-KV chat loop
    from a checkpoint's own Jinja2 `chat_template`.

    HF templates render WHOLE conversations; the Interpreter appends message
    deltas to a live KV cache. The adapter exploits the prefix property of
    append-only chats (render(msgs[:i]) is a prefix of render(msgs[:i+1]) for
    standard templates) and emits only the suffix each call. The built-in
    mustache ChatTemplates remain the fallback for checkpoints without a
    template.
    """

    begin_text = ""  # bos is emitted by the template's own first delta

    def __init__(self, template: str, *, bos_token: str = "",
                 eos_token: str = "", tools=None):
        self.template = template
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.tools = tools

    def _render(self, messages, add_generation_prompt: bool) -> str:
        return render_chat_template(
            self.template, messages,
            add_generation_prompt=add_generation_prompt,
            tools=self.tools, bos_token=self.bos_token,
            eos_token=self.eos_token,
        )

    def _delta(self, prev: str, full: str) -> str:
        if not full.startswith(prev):
            raise TemplateError(
                "chat template is not append-only (rendering the extended "
                "conversation does not extend the previous rendering); "
                "re-render the whole prompt instead of streaming deltas"
            )
        return full[len(prev):]

    def render_message_delta(self, messages) -> str:
        """Text to append for the LAST message of `messages`."""
        prev = self._render(messages[:-1], False) if len(messages) > 1 else ""
        return self._delta(prev, self._render(messages, False))

    def render_generation_header(self, messages) -> str:
        """The assistant generation prompt suffix for the current state."""
        return self._delta(self._render(messages, False),
                           self._render(messages, True))


def _token_text(value: Any) -> str:
    """tokenizer_config.json token fields are plain strings or AddedToken
    dicts ({"content": ...})."""
    if isinstance(value, Mapping):
        return str(value.get("content", ""))
    return str(value) if value else ""


def load_hf_chat_templates(model_dir: str | Path) -> Optional["HFChatTemplates"]:
    """Build an HFChatTemplates from a checkpoint directory's
    tokenizer_config.json (None when it ships no chat template)."""
    template = load_chat_template(model_dir)
    if template is None:
        return None
    cfg = json.loads((Path(model_dir) / "tokenizer_config.json").read_text())
    return HFChatTemplates(
        template,
        bos_token=_token_text(cfg.get("bos_token")),
        eos_token=_token_text(cfg.get("eos_token")),
    )
