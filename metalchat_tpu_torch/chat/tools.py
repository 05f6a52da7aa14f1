"""JSON-schema tool calling (port of the JAX package's ``chat/tools.py``).

Tools are declared with a JSON-schema parameter spec, the model's output is
scanned for a ``<|python_tag|>{json}`` call, validated and dispatched to the
registered handler.

The JAX package validates with the ``jsonschema`` package; this module
keeps its own validator for the subset tool schemas use: ``type`` (JSON's
rules: a bool is not an integer or a number, a float with an integral
value is an integer), ``properties``, ``required``, ``enum``, ``items`` and
``additionalProperties``, beside the annotations ``title``,
``description``, ``default``, ``examples`` and ``$comment``, which assert
nothing. Any other keyword raises `NotImplementedError`. It reports the
error ``jsonschema.validate`` raises (Draft 2020-12, its ``best_match``
choice among the errors) with the same text, since the interpreter feeds
``str(error)`` back to the model.
"""

from __future__ import annotations

import json
import numbers
import re
from collections.abc import Mapping as _Mapping
from collections.abc import Sequence as _Sequence
from dataclasses import dataclass, field
from pprint import pformat
from textwrap import dedent, indent
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

PYTHON_TAG = "<|python_tag|>"

# Prompt-side description of the call format (the {{metalchat.command_format}}
# template builtin).
COMMAND_FORMAT = (
    'Respond with a JSON object {"name": <tool>, "parameters": {...}} '
    f"prefixed by {PYTHON_TAG} to call a tool."
)

# -------------------------------------------------------------- validation

_TYPES: Dict[str, Callable[[Any], bool]] = {
    "array": lambda v: isinstance(v, list),
    "boolean": lambda v: isinstance(v, bool),
    "integer": lambda v: not isinstance(v, bool) and (
        isinstance(v, int) or (isinstance(v, float) and v.is_integer())),
    "null": lambda v: v is None,
    "number": lambda v: not isinstance(v, bool) and isinstance(v, numbers.Number),
    "object": lambda v: isinstance(v, dict),
    "string": lambda v: isinstance(v, str),
}
_ANNOTATIONS = frozenset(("title", "description", "default", "examples", "$comment"))


class SchemaError(ValueError):
    """A parameter schema this validator cannot read."""


class ValidationError(ValueError):
    """An instance that fails its schema. ``str()`` is ``jsonschema``'s text:
    the message, the failing keyword with the schema that holds it, and the
    instance at that place."""

    def __init__(self, message: str, validator: str, validator_value: Any,
                 instance: Any, schema: Mapping[str, Any]):
        super().__init__(message)
        self.message = message
        self.validator = validator
        self.validator_value = validator_value
        self.instance = instance
        self.schema = schema
        self.path: List[Any] = []          # instance path from the root
        self.schema_path: List[Any] = [validator]

    def __str__(self) -> str:
        prefix = 16 * " "
        return dedent(
            f"""\
            {self.message}

            Failed validating {self.validator!r} in {_index("schema", self.schema_path[:-1])}:
                {_pretty(self.schema, prefix=prefix)}

            On {_index("instance", self.path)}:
                {_pretty(self.instance, prefix=prefix)}
            """.rstrip(),
        )

    def _matches_type(self) -> bool:
        expected = self.schema.get("type") if isinstance(self.schema, dict) else None
        if expected is None:
            return False
        return any(_is_type(self.instance, t) for t in _as_list(expected))


def _pretty(thing: Any, prefix: str) -> str:
    return indent(pformat(thing, width=72, sort_dicts=False), prefix).lstrip()


def _index(container: str, indices) -> str:
    if not indices:
        return container
    return f"{container}[{']['.join(repr(i) for i in indices)}]"


def _as_list(types) -> List[str]:
    return [types] if isinstance(types, str) else list(types)


def _is_type(instance: Any, name: str) -> bool:
    try:
        return _TYPES[name](instance)
    except KeyError:
        raise SchemaError(f"unknown JSON type {name!r}") from None


def _equal(one: Any, two: Any) -> bool:
    """JSON equality: ``True`` is not ``1``, recursively."""
    if one is two:
        return True
    if isinstance(one, str) or isinstance(two, str):
        return one == two
    if isinstance(one, _Sequence) and isinstance(two, _Sequence):
        return len(one) == len(two) and all(_equal(a, b) for a, b in zip(one, two))
    if isinstance(one, _Mapping) and isinstance(two, _Mapping):
        return len(one) == len(two) and all(k in two and _equal(v, two[k])
                                            for k, v in one.items())
    if isinstance(one, bool) or isinstance(two, bool):
        return isinstance(one, bool) and isinstance(two, bool) and one == two
    return one == two


def _descend(instance: Any, schema: Any, path=None, schema_path=None
             ) -> Iterator[ValidationError]:
    """Every error of ``instance`` against ``schema``, in the schema's
    keyword order, with paths relative to the caller."""
    for error in iter_errors(instance, schema):
        if path is not None:
            error.path.insert(0, path)
        if schema_path is not None:
            error.schema_path.insert(0, schema_path)
        yield error


def iter_errors(instance: Any, schema: Any) -> Iterator[ValidationError]:
    """Every error of ``instance`` against ``schema`` (a dict, or ``True``)."""
    if schema is True:
        return
    if not isinstance(schema, dict):
        raise NotImplementedError(f"schema {schema!r}: only object schemas (and true) "
                                  "are supported")
    for key, value in schema.items():
        if key in _ANNOTATIONS:
            continue
        check = _KEYWORDS.get(key)
        if check is None:
            raise NotImplementedError(
                f"JSON-schema keyword {key!r} is not supported (supported: "
                f"{', '.join(sorted(_KEYWORDS))})")
        for error in check(value, instance, schema):
            if error.schema is None:
                error.validator, error.validator_value = key, value
                error.instance, error.schema = instance, schema
                error.schema_path = [key]
            else:
                error.schema_path.insert(0, key)
            yield error


def _new(message: str) -> ValidationError:
    """An error of the keyword being checked; `iter_errors` fills in where."""
    return ValidationError(message, None, None, None, None)


def _type(types, instance, schema):
    names = _as_list(types)
    if not any(_is_type(instance, t) for t in names):
        yield _new(f"{instance!r} is not of type {', '.join(repr(t) for t in names)}")


def _properties(properties, instance, schema):
    if not _is_type(instance, "object"):
        return
    for name, sub in properties.items():
        if name in instance:
            yield from _descend(instance[name], sub, path=name, schema_path=name)


def _required(required, instance, schema):
    if not _is_type(instance, "object"):
        return
    for name in required:
        if name not in instance:
            yield _new(f"{name!r} is a required property")


def _enum(enums, instance, schema):
    if all(not _equal(each, instance) for each in enums):
        yield _new(f"{instance!r} is not one of {enums!r}")


def _items(items, instance, schema):
    if not _is_type(instance, "array") or not instance:
        return
    if items is False:
        rest = instance if len(instance) != 1 else instance[0]
        yield _new(f"Expected at most 0 items but found {len(instance)} extra: {rest!r}")
        return
    for index, item in enumerate(instance):
        yield from _descend(item, items, path=index)


def _additional_properties(extra_schema, instance, schema):
    if not _is_type(instance, "object"):
        return
    extras = sorted((k for k in instance if k not in schema.get("properties", {})), key=str)
    if isinstance(extra_schema, dict):
        for name in extras:
            yield from _descend(instance[name], extra_schema, path=name)
    elif not extra_schema and extras:
        verb = "was" if len(extras) == 1 else "were"
        yield _new(f"Additional properties are not allowed "
                   f"({', '.join(repr(e) for e in extras)} {verb} unexpected)")


_KEYWORDS = {"type": _type, "properties": _properties, "required": _required,
             "enum": _enum, "items": _items, "additionalProperties": _additional_properties}


def _relevance(error: ValidationError):
    """``jsonschema.exceptions.relevance`` for keywords none of which is
    weak or strong: the shallowest error, then the largest path."""
    return (-len(error.path), error.path, True, False, not error._matches_type())


def validate(instance: Any, schema: Mapping[str, Any]) -> None:
    """Raise the most relevant `ValidationError` of ``instance``, if any."""
    best = max(iter_errors(instance, schema), key=_relevance, default=None)
    if best is not None:
        raise best


# ----------------------------------------------------------------- commands

@dataclass
class Command:
    """A callable tool with a JSON-schema parameter declaration."""

    name: str
    description: str
    parameters: Mapping[str, Any]           # JSON schema for the arguments
    handler: Optional[Callable[..., Any]] = None

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": dict(self.parameters),
        }

    def validate(self, arguments: Mapping[str, Any]) -> None:
        validate(dict(arguments), dict(self.parameters))

    def __call__(self, **arguments: Any) -> Any:
        if self.handler is None:
            raise RuntimeError(f"command {self.name!r} has no handler")
        self.validate(arguments)
        return self.handler(**arguments)


@dataclass
class CommandStatement:
    """A parsed tool invocation."""

    name: str
    parameters: Dict[str, Any] = field(default_factory=dict)

    def __getitem__(self, key: str) -> Any:
        return self.parameters[key]


class CommandScanner:
    """Detect and parse ``<|python_tag|>{json}`` tool calls in model output."""

    _JSON_RE = re.compile(r"\{.*\}", re.S)

    def __init__(self, commands: Optional[List[Command]] = None):
        self.commands: Dict[str, Command] = {}
        for c in commands or []:
            self.register(c)

    def register(self, command: Command) -> None:
        self.commands[command.name] = command

    def describe_all(self) -> str:
        """The {{metalchat.commands}} builtin payload."""
        return json.dumps([c.describe() for c in self.commands.values()], indent=2)

    def parse(self, text: str) -> Optional[CommandStatement]:
        """Extract a tool call from generated text, or None."""
        if PYTHON_TAG in text:
            payload = text.split(PYTHON_TAG, 1)[1]
        else:
            payload = text
        m = self._JSON_RE.search(payload)
        if not m:
            return None
        try:
            obj = json.loads(m.group(0))
        except json.JSONDecodeError:
            return None
        if not isinstance(obj, dict) or "name" not in obj:
            return None
        params = obj.get("parameters", obj.get("arguments", {}))
        if not isinstance(params, dict):
            return None
        return CommandStatement(name=str(obj["name"]), parameters=params)

    def execute(self, statement: CommandStatement) -> Any:
        command = self.commands.get(statement.name)
        if command is None:
            raise KeyError(f"unknown command {statement.name!r}")
        return command(**statement.parameters)
