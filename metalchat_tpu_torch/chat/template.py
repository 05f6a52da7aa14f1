"""Mustache-style prompt templating (port of the JAX package's
``chat/template.py``): a minimal mustache engine covering the subset chat
prompts use:

  * ``{{var}}``            — HTML-escape-free interpolation (prompts aren't HTML)
  * ``{{{var}}}``          — same (kept for template compatibility)
  * ``{{#name}}...{{/name}}`` — sections: truthy / list iteration / dict scope
  * ``{{^name}}...{{/name}}`` — inverted sections
  * ``{{! comment }}``     — dropped
  * dotted lookups (``{{user.name}}``, ``{{metalchat.commands}}``)
"""

from __future__ import annotations

import re
from typing import Any, List, Mapping

_TAG = re.compile(r"\{\{\{(.+?)\}\}\}|\{\{(.+?)\}\}", re.S)


def _lookup(path: str, scopes: List[Any]) -> Any:
    path = path.strip()
    if path == ".":
        return scopes[-1]
    for scope in reversed(scopes):
        value: Any = scope
        found = True
        for part in path.split("."):
            if isinstance(value, Mapping) and part in value:
                value = value[part]
            elif hasattr(value, part):
                value = getattr(value, part)
            else:
                found = False
                break
        if found:
            return value
    return None


def _render(template: str, scopes: List[Any]) -> str:
    out: List[str] = []
    pos = 0
    while pos < len(template):
        m = _TAG.search(template, pos)
        if not m:
            out.append(template[pos:])
            break
        out.append(template[pos : m.start()])
        tag = (m.group(1) or m.group(2)).strip()
        pos = m.end()

        if tag.startswith("!"):
            continue
        if tag.startswith("#") or tag.startswith("^"):
            inverted = tag.startswith("^")
            name = tag[1:].strip()
            close = re.compile(r"\{\{\s*/\s*" + re.escape(name) + r"\s*\}\}")
            end = close.search(template, pos)
            if not end:
                raise ValueError(f"unclosed section {{#{name}}}")
            body = template[pos : end.start()]
            pos = end.end()
            value = _lookup(name, scopes)
            truthy = bool(value)
            if inverted:
                if not truthy:
                    out.append(_render(body, scopes))
            elif isinstance(value, (list, tuple)):
                for item in value:
                    out.append(_render(body, scopes + [item]))
            elif truthy:
                scope = value if isinstance(value, Mapping) else scopes[-1]
                out.append(_render(body, scopes + [scope]))
            continue
        if tag.startswith("/"):
            raise ValueError(f"unexpected closing tag {{{{{tag}}}}}")
        value = _lookup(tag, scopes)
        out.append("" if value is None else str(value))
    return "".join(out)


def render_template(template: str, variables: Mapping[str, Any]) -> str:
    return _render(template, [dict(variables)])
