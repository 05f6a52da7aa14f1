"""The port's chat layer (metalchat_tpu_torch/chat/) against the JAX
package's, on the CPU.

* ``render_template`` strings, the scanners' verdicts, tool-call parsing,
  and the validator's verdicts and error text against ``jsonschema``'s
  (``str(ValidationError)`` equal, the text the interpreter feeds back).
* `Interpreter` against the JAX ``Interpreter``: ``tests/test_chat.py``'s
  tiny random Llama with its byte tokenizer, and the trained fixture
  (W4A8 fused, and dense) with its ``tokenizer.model``, f32 (the JAX CPU
  backend has no bf16 dot), greedy. Per turn: reply ids and text
  identical, ``pos`` equal, the dense cache within 1e-5. Template
  variables, the ``exec`` tool loop with scripted replies, context
  exhaustion at the same point, sinks rolling at the same position, HF
  template sessions, ids the model cannot embed.
* The card's route on the CPU: the session's decode step driven through a
  stand-in graph whose capture records the step and whose replay runs it,
  one capture a session.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest
import torch

from metalchat_tpu.chat import interpreter as jinterp
from metalchat_tpu.chat import scanners as jscanners
from metalchat_tpu.chat import template as jtemplate
from metalchat_tpu.chat import tools as jtools
from metalchat_tpu.chat.hf_template import HFChatTemplates as JHFChatTemplates
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import open_safetensors as jopen
from metalchat_tpu.models import init_random_params as jinit_random_params
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu.sampling import SamplerConfig as JSamplerConfig
from metalchat_tpu.text.bpe import BytePairEncoder as JBytePairEncoder
from metalchat_tpu.text.loaders import load_tiktoken_model as jload_tiktoken_model
from metalchat_tpu_torch.chat import interpreter as interp
from metalchat_tpu_torch.chat import scanners, template, tools
from metalchat_tpu_torch.chat.hf_template import HFChatTemplates, render_chat_template
from metalchat_tpu_torch.config import LlamaConfig, load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.ops._build import CountedGraph
from metalchat_tpu_torch.sampling import SamplerConfig
from metalchat_tpu_torch.text import BytePairEncoder, TokenKind, load_tiktoken_model
from test_model import TINY_LLAMA
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
PYTHON_TAG = tools.PYTHON_TAG
GREEDY, JGREEDY = SamplerConfig.greedy(), JSamplerConfig.greedy()
CACHE_ATOL = 1e-5
DRIFT_SHARE, DRIFT_ATOL = 0.25, 0.1

# -- templating, scanners ---------------------------------------------------------

TEMPLATES = [
    ("Hello {{name}}, {{a.b}}!", {"name": "world", "a": {"b": 42}}),
    ("{{missing}}|{{{raw}}}", {"raw": "<x>"}),
    ("{{#items}}[{{.}}]{{/items}}{{^items}}none{{/items}}", {"items": [1, 2, 3]}),
    ("{{#items}}[{{.}}]{{/items}}{{^items}}none{{/items}}", {"items": []}),
    ("{{#on}}yes{{/on}}{{! a comment }}x", {"on": True}),
    ("{{#user}}{{name}} ({{role}}){{/user}}", {"user": {"name": "ann"}, "role": "dev"}),
    ("{{#rows}}{{#cells}}{{.}},{{/cells}};{{/rows}}", {"rows": [{"cells": [1, 2]},
                                                                 {"cells": []}]}),
    ("<|start_header_id|>{{role}}<|end_header_id|>\n\n{{content}}<|eot_id|>",
     {"role": "user", "content": "multi\nline {{not a tag}}"}),
    ("{{metalchat.command_format}}", {"metalchat": {"command_format": tools.COMMAND_FORMAT}}),
]


@pytest.mark.parametrize("tpl,variables", TEMPLATES)
def test_render_template_identical(tpl, variables):
    assert template.render_template(tpl, variables) == jtemplate.render_template(tpl, variables)


@pytest.mark.parametrize("tpl", ["{{#open}}...", "{{/close}}"])
def test_render_template_errors(tpl):
    with pytest.raises(ValueError):
        jtemplate.render_template(tpl, {"open": True})
    with pytest.raises(ValueError):
        template.render_template(tpl, {"open": True})


def test_scanners_identical():
    seq = [1, 5, 3, 9, 7, 7, 2, 5]
    for make in (lambda m: m.StopTokenScanner([7, 9]), lambda m: m.LimitScanner(3),
                 lambda m: m.CompositeScanner([m.StopTokenScanner([5]), m.LimitScanner(4)]),
                 lambda m: m.CompositeScanner([m.StopTokenScanner([5]), m.LimitScanner(2)],
                                              op="any")):
        ours, theirs = make(scanners), make(jscanners)
        for _ in range(2):
            assert [ours.scan(t) for t in seq] == [theirs.scan(t) for t in seq]
            ours.reset()
            theirs.reset()
    with pytest.raises(ValueError):
        scanners.CompositeScanner([], op="xor")


# -- tool calls ---------------------------------------------------------------------

MULTIPLY = {"type": "object",
            "properties": {"a": {"type": "integer"}, "b": {"type": "integer"}},
            "required": ["a", "b"]}
RICH = {
    "type": "object",
    "title": "search",
    "description": "a search tool",
    "properties": {
        "query": {"type": "string", "description": "what to find"},
        "limit": {"type": "integer"},
        "score": {"type": "number"},
        "exact": {"type": "boolean"},
        "mode": {"type": "string", "enum": ["fast", "full"]},
        "tags": {"type": "array", "items": {"type": "string"}},
        "level": {"enum": [1, 2, True, None, [1, 2], {"k": 1}]},
        "where": {"type": "object", "properties": {"lat": {"type": "number"},
                                                   "lon": {"type": ["number", "null"]}},
                  "required": ["lat"], "additionalProperties": False},
        "extra": {"type": "object", "additionalProperties": {"type": "integer"}},
        "none": {"type": "array", "items": False},
    },
    "required": ["query"],
    "additionalProperties": False,
}
ARGS = [
    (MULTIPLY, {"a": 6, "b": 7}), (MULTIPLY, {"a": "x"}), (MULTIPLY, {"a": 1}),
    (MULTIPLY, {"a": True, "b": 2}), (MULTIPLY, {"a": 1.0, "b": 2.0}),
    (MULTIPLY, {"a": 1.5, "b": None}), (MULTIPLY, {}), (MULTIPLY, {"a": 1, "b": 2, "c": 3}),
    (RICH, {"query": "x"}), (RICH, {"query": 3}), (RICH, {"limit": 2}),
    (RICH, {"query": "x", "limit": 2.5}), (RICH, {"query": "x", "score": True}),
    (RICH, {"query": "x", "exact": 1}), (RICH, {"query": "x", "mode": "slow"}),
    (RICH, {"query": "x", "tags": ["a", 1, "b", None]}), (RICH, {"query": "x", "tags": "a"}),
    (RICH, {"query": "x", "level": 1.0}), (RICH, {"query": "x", "level": False}),
    (RICH, {"query": "x", "level": [1, 2]}), (RICH, {"query": "x", "level": {"k": True}}),
    (RICH, {"query": "x", "where": {"lon": "w"}}),
    (RICH, {"query": "x", "where": {"lat": 1, "lon": None, "alt": 3, "b": 1}}),
    (RICH, {"query": "x", "extra": {"p": 1, "q": "two", "r": 3.5}}),
    (RICH, {"query": "x", "none": [1]}), (RICH, {"query": "x", "none": [1, 2]}),
    (RICH, {"query": "x", "z": 1, "y": "long " * 30}), (RICH, {"z": 1}),
    (RICH, {"query": ["x"] * 30, "tags": [{"deep": list(range(30))}]}),
]


def _jsonschema_text(args, schema):
    try:
        jsonschema.validate(instance=dict(args), schema=schema)
    except jsonschema.ValidationError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("schema,args", ARGS)
def test_validation_identical_to_jsonschema(schema, args):
    want = _jsonschema_text(args, schema)
    cmd = tools.Command("t", "d", schema, handler=lambda **kw: "ok")
    if want is None:
        cmd.validate(args)
        assert cmd(**args) == "ok"
        return
    with pytest.raises(tools.ValidationError) as got:
        cmd.validate(args)
    assert str(got.value) == want


@pytest.mark.parametrize("schema", [
    {"type": "object", "properties": {"a": {"type": "string", "minLength": 2}}},
    {"type": "object", "patternProperties": {"^x": {}}},
    {"oneOf": [{"type": "string"}]},
    {"type": "object", "properties": {"a": {"$ref": "#/defs/a"}}},
])
def test_unsupported_keywords_raise(schema):
    with pytest.raises(NotImplementedError, match="keyword"):
        tools.validate({"a": "xyz", "x1": 1}, schema)


def _scanner(module):
    return module.CommandScanner([module.Command(
        name="multiply", description="multiply two integers", parameters=MULTIPLY,
        handler=lambda a, b: a * b)])


@pytest.mark.parametrize("text", [
    f'I will compute.{PYTHON_TAG}{{"name": "multiply", "parameters": {{"a": 12135, "b": 9312}}}}',
    f'{PYTHON_TAG}{{"name": "multiply", "arguments": {{"a": 1, "b": 2}}}} trailing',
    '{"name": "multiply", "parameters": {"a": 3, "b": 4}}',
    f"{PYTHON_TAG}{{not json}}", "no call here", f'{PYTHON_TAG}{{"parameters": {{}}}}',
    f'{PYTHON_TAG}{{"name": "multiply", "parameters": [1, 2]}}',
    f'{PYTHON_TAG}{{"name": "nope", "parameters": {{}}}}',
    f'{PYTHON_TAG}{{"name": "multiply", "parameters": {{"a": "x"}}}}',
])
def test_command_parse_and_execute_identical(text):
    ours, theirs = _scanner(tools), _scanner(jtools)
    assert ours.describe_all() == theirs.describe_all()
    got, want = ours.parse(text), theirs.parse(text)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert (got.name, got.parameters) == (want.name, want.parameters)

    def outcome(scanner, statement):
        try:
            return "ok", scanner.execute(statement)
        except Exception as exc:  # the interpreter writes f"error: {exc}" back
            return "error", f"error: {exc}"

    assert outcome(ours, got) == outcome(theirs, want)


# -- the interpreter ----------------------------------------------------------------

def _byte_tokenizer(cls):
    """tests/test_chat.py's: 256 byte tokens + llama3-style specials."""
    tok = cls({bytes([b]): b for b in range(256)}, split_pattern=None)
    kinds = [("<|begin_of_text|>", TokenKind.BEGIN_TEXT), ("<|end_of_text|>", TokenKind.END_TEXT),
             ("<|start_header_id|>", TokenKind.BEGIN_HEADER),
             ("<|end_header_id|>", TokenKind.END_HEADER), ("<|eot_id|>", TokenKind.END_TURN),
             ("<|python_tag|>", TokenKind.IPYTHON)]
    for i, (name, kind) in enumerate(kinds):
        tok.add_special(name, 256 + i, kind)
    return tok


def _port_config(jcfg):
    return LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig)})


@pytest.fixture(scope="module")
def tiny():
    """tests/test_chat.py's session parts, for both packages."""
    jcfg = TINY_LLAMA.replace(vocab_size=262, max_seq_len=256)
    jparams = jinit_random_params(jcfg, seed=77, dtype=jnp.float32)
    return {"jax": (jparams, jcfg, _byte_tokenizer(JBytePairEncoder)),
            "port": (params_from_numpy(jax_tree_to_numpy(jparams), "cpu"), _port_config(jcfg),
                     _byte_tokenizer(BytePairEncoder))}


@pytest.fixture(scope="module")
def fixture():
    """The trained fixture in f32, W4A8 (fused) and dense, for both packages,
    with its byte tokenizer.model (Llama-3 specials at 256-511)."""
    jcfg = jload_config(FIXTURE / "config.json")
    dense = jload_params(jopen(FIXTURE), jcfg, dtype=jnp.float32, max_seq_len=256)
    w4a8 = jfuse(jquantize_params(dense, bits=4, group_size=None, act_bits=8), jcfg)
    cfg = load_config(FIXTURE / "config.json")
    out = {}
    for name, jp in (("dense", dense), ("w4a8", w4a8)):
        out[name] = {"jax": (jp, jcfg, jload_tiktoken_model(FIXTURE / "tokenizer.model")),
                     "port": (params_from_numpy(jax_tree_to_numpy(jp), "cpu"), cfg,
                              load_tiktoken_model(FIXTURE / "tokenizer.model"))}
    return out


def _sessions(parts, templates=None, jtemplates=None, **kw):
    """A JAX session and a port session on the same parameters; mustache
    ``templates`` go to both."""
    jparams, jcfg, jtok = parts["jax"]
    params, cfg, tok = parts["port"]
    if jtemplates is None and templates is not None:
        jtemplates = jinterp.ChatTemplates(**dataclasses.asdict(templates))
    return (jinterp.Interpreter(jparams, jcfg, jtok, sampler=JGREEDY, templates=jtemplates,
                                **kw),
            interp.Interpreter(params, cfg, tok, sampler=GREEDY, templates=templates, **kw))


def _turn(session, content, role="user"):
    """write + read; the reply's ids (spied on read_tokens) and text."""
    session.write(content, role=role)
    ids = []
    read_tokens = session.read_tokens

    def spy():
        for t in read_tokens():
            ids.append(t)
            yield t

    session.read_tokens = spy
    try:
        text = session.read()
    finally:
        del session.read_tokens
    return ids, text


def _same_cache(jsession, session, act_quant: bool):
    """Dense weights: the cache within 1e-5. W4A8: the act-quant drift of
    ROADMAP.md's Queue C (an ulp upstream moves an int8 activation code by
    one quantum at a rounding boundary, in prompts of more than one token)
    moves the K/V of the layers after such a flip; there the cache is held
    within 1e-5 on all but ``DRIFT_SHARE`` of its elements and within
    ``DRIFT_ATOL`` everywhere (the fixture's K/V reach about ±10)."""
    for name in ("k", "v"):
        got, want = getattr(session.cache, name).numpy(), np.asarray(getattr(jsession.cache, name))
        if not act_quant:
            np.testing.assert_allclose(got, want, rtol=0, atol=CACHE_ATOL)
            continue
        diff = np.abs(got - want)
        assert (diff > CACHE_ATOL).mean() <= DRIFT_SHARE and diff.max() <= DRIFT_ATOL, (
            name, (diff > CACHE_ATOL).mean(), diff.max())


def _converse(jsession, session, turns, act_quant: bool = False):
    replies = []
    for content in turns:
        want = _turn(jsession, content)
        got = _turn(session, content)
        assert got == want, content
        assert session.pos == jsession.pos and session._buffer == jsession._buffer
        _same_cache(jsession, session, act_quant)
        replies.append(got)
    return replies


def test_interpreter_tiny_identical(tiny):
    jsession, session = _sessions(tiny, max_reply_tokens=8, max_seq_len=256)
    assert session.stop_ids == jsession.stop_ids
    replies = _converse(jsession, session, ["hi there", "again"])
    assert all(len(ids) == 8 for ids, _ in replies)
    assert session.turns[1].start_pos > session.turns[0].start_pos
    assert session.captures == 0  # no graph on the CPU


# Short messages: turn 2's buffer (the message alone) is 2-16 tokens, the
# decode step's window route; with the Llama-3 template every turn's
# buffer is longer than 16 tokens (the prefill route).
SHORT = interp.ChatTemplates(begin_text="<|begin_of_text|>", header="",
                             message="{{content}}")


@pytest.mark.parametrize("scheme", ["w4a8", "dense"])
@pytest.mark.parametrize("short", [False, True], ids=["llama3", "short"])
def test_interpreter_fixture_identical(fixture, scheme, short):
    parts = fixture[scheme]
    jsession, session = _sessions(parts, SHORT if short else None, max_reply_tokens=12,
                                  max_seq_len=256)
    turns = (["def main():\n    ", "    x = 1\n"] if short else
             ["Write a function that adds two numbers.", "def add(a, b):\n    "])
    replies = _converse(jsession, session, turns, act_quant=scheme == "w4a8")
    assert all(ids for ids, _ in replies)
    assert (session.turns[1].prefill_tokens <= 16) == short


def test_template_variables(tiny):
    tpl = interp.ChatTemplates(begin_text="<|begin_of_text|>",
                               header="<|start_header_id|>{{role}}<|end_header_id|>",
                               message="[{{role}}|{{persona}}] {{content}}<|eot_id|>")
    jsession, session = _sessions(tiny, tpl, max_seq_len=256)
    for s in (jsession, session):
        s.declare("persona", "pirate")
        s.write("ahoy")
    assert session._buffer == jsession._buffer
    assert "[user|pirate] ahoy" in session.tokenizer.decode(session._buffer)
    commands = interp.ChatTemplates("", "", "{{metalchat.commands}}|{{metalchat.command_format}}")
    jsession, session = _sessions(tiny, commands, max_seq_len=1024)
    session.register_command(_scanner(tools).commands["multiply"])
    jsession.register_command(_scanner(jtools).commands["multiply"])
    session.write("x")
    jsession.write("x")
    assert session._buffer == jsession._buffer


@pytest.mark.parametrize("call,result", [
    ('{"name": "multiply", "parameters": {"a": 6, "b": 7}}', "42"),
    ('{"name": "multiply", "parameters": {"a": "6"}}', None),
    ('{"name": "divide", "parameters": {}}', None),
])
def test_exec_tool_loop(tiny, monkeypatch, call, result):
    """exec(): scripted replies; the tool's result (or its error text) is
    written back as an ipython message, identically in both packages."""
    outs = []
    for session, module in zip(_sessions(tiny, max_seq_len=1024), (jtools, tools)):
        session.register_command(_scanner(module).commands["multiply"])
        replies = iter([f"{PYTHON_TAG}{call}", "the answer"])
        seen = []
        monkeypatch.setattr(session, "read", lambda: next(replies))
        real_write = session.write
        monkeypatch.setattr(session, "write", lambda content, role="user":
                            seen.append((role, content)) or real_write(content, role))
        outs.append((session.exec("what is 6*7?"), seen, list(session._buffer)))
    assert outs[0] == outs[1]
    out, seen, _ = outs[1]
    assert out == "the answer" and seen[0] == ("user", "what is 6*7?")
    assert seen[1][0] == "ipython"
    if result is not None:
        assert seen[1][1] == result
    else:
        assert seen[1][1].startswith("error: ")


def test_context_exhaustion_raises(tiny):
    for session in _sessions(tiny, max_seq_len=32):
        session.write("x" * 200, role="user")
        with pytest.raises(RuntimeError, match="context window"):
            session.read()


def test_context_fills_mid_reply(tiny):
    """Without sinks a reply ends where the cache fills: the same ids and
    the same pos in both packages."""
    jsession, session = _sessions(tiny, max_seq_len=48, max_reply_tokens=64)
    ids, _ = _converse(jsession, session, ["y" * 12])[0]
    assert session.pos == 47 and len(ids) < 64


def test_sinks_roll_at_the_same_position(tiny):
    """A 48-position cache with 4 sinks and 40-token replies: the cache
    rolls (shift 11) mid-reply, at the same points in both packages."""
    jsession, session = _sessions(tiny, SHORT, max_seq_len=48, max_reply_tokens=40,
                                  sink_tokens=4)
    _converse(jsession, session, ["y" * 6, "z" * 8])
    assert sum(t.rolls for t in session.turns) >= 2


def test_ids_outside_the_vocabulary_raise(fixture):
    """The fixture's vocabulary is 384 ids, its tokenizer's specials run to
    511: an id the model cannot embed raises on the host, naming it."""
    _, session = _sessions(fixture["dense"], max_seq_len=256)
    session.write("<|reserved_special_token_200|> hi")
    bad = session.tokenizer.specials.id_of("<|reserved_special_token_200|>")
    assert bad >= 384
    with pytest.raises(ValueError, match=rf"token id {bad} .*reserved_special_token_200.* 384"):
        session.read()


# -- HF chat templates -----------------------------------------------------------------

LLAMA3ISH = (
    "{{ bos_token }}{% for m in messages %}"
    "{{ '<|start_header_id|>' + m['role'] + '<|end_header_id|>\n\n' + m['content'] + '<|eot_id|>' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)
GEMMAISH = (
    "{{ '<bos>' }}{% for m in messages %}"
    "{{ '<start_of_turn>' + m['role'] + '\n' + m['content'] + '<end_of_turn>\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<start_of_turn>model\n' }}{% endif %}"
)


@pytest.mark.parametrize("tpl", [LLAMA3ISH, GEMMAISH])
def test_hf_template_deltas_identical(tpl):
    msgs = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi!"},
            {"role": "assistant", "content": "yo"}, {"role": "user", "content": "more"}]
    ours = HFChatTemplates(tpl, bos_token="<|begin_of_text|>")
    theirs = JHFChatTemplates(tpl, bos_token="<|begin_of_text|>")
    emitted = ""
    for i in range(1, len(msgs) + 1):
        delta = ours.render_message_delta(msgs[:i])
        assert delta == theirs.render_message_delta(msgs[:i])
        emitted += delta
        assert ours.render_generation_header(msgs[:i]) == \
            theirs.render_generation_header(msgs[:i])
    assert emitted == render_chat_template(tpl, msgs, add_generation_prompt=False,
                                           bos_token="<|begin_of_text|>")


def test_hf_template_matches_transformers():
    """The port's deltas against transformers' own renderer (the oracle of
    tests/test_hf_chat_session.py)."""
    from transformers.utils.chat_template_utils import render_jinja_template

    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "a"},
            {"role": "assistant", "content": "b"}, {"role": "user", "content": "c"}]
    tpl = HFChatTemplates(LLAMA3ISH, bos_token="<|begin_of_text|>")
    emitted = "".join(tpl.render_message_delta(msgs[:i]) for i in range(1, len(msgs) + 1))
    want, _ = render_jinja_template(conversations=[msgs], chat_template=LLAMA3ISH,
                                    add_generation_prompt=False, tools=None, documents=None,
                                    bos_token="<|begin_of_text|>")
    assert emitted == want[0]


def test_load_hf_chat_templates_identical(tmp_path):
    from metalchat_tpu.chat.hf_template import load_hf_chat_templates as jload
    from metalchat_tpu_torch.chat.hf_template import load_hf_chat_templates

    assert load_hf_chat_templates(tmp_path) is None
    for template in (LLAMA3ISH, [{"name": "tool_use", "template": GEMMAISH},
                                 {"name": "default", "template": LLAMA3ISH}]):
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({
            "chat_template": template, "bos_token": {"content": "<|begin_of_text|>"},
            "eos_token": "<|eot_id|>"}))
        ours, theirs = load_hf_chat_templates(tmp_path), jload(tmp_path)
        assert (ours.template, ours.bos_token, ours.eos_token) == (
            theirs.template, theirs.bos_token, theirs.eos_token) == (
            LLAMA3ISH, "<|begin_of_text|>", "<|eot_id|>")


@pytest.mark.parametrize("tpl", [LLAMA3ISH, GEMMAISH])
def test_interpreter_session_with_hf_template(tiny, tpl):
    """tests/test_hf_chat_session.py's session: after each reply the next
    write's delta brings the emitted text to the full rendering; replies,
    buffers and caches identical to the JAX session's."""
    jsession, session = _sessions(
        tiny, HFChatTemplates(tpl, bos_token="<|begin_of_text|>"),
        JHFChatTemplates(tpl, bos_token="<|begin_of_text|>"), max_reply_tokens=8)
    _converse(jsession, session, ["hello"])
    for s in (jsession, session):
        s.write("again", role="user")
    assert session._hf_emitted == session.templates._render(session._messages, False)
    assert (session._hf_emitted, session._messages, session._buffer) == (
        jsession._hf_emitted, jsession._messages, jsession._buffer)


# -- the card's route, with a stand-in graph ----------------------------------------

class _Recorder:
    """A stand-in CUDA graph: holds the recorded step, a replay runs it."""

    def __init__(self, events):
        self.events, self.fn = events, None

    def register_generator_state(self, generator):
        pass

    def replay(self):
        self.events.append("replay")
        self.fn()


class ExecutingGraph(CountedGraph):
    """`capture` records the step and runs nothing (a capture on the card
    runs nothing); `replay` runs it."""

    events: list = []

    def __init__(self):
        super().__init__(graph=_Recorder(self.events))

    def capture(self, fn):
        self.events.append("capture")
        self.graph.fn = fn


class StandInStep(interp.DecodeStep):
    def _graph_route(self, device):
        return True


def test_one_capture_a_session(fixture, monkeypatch):
    """Two turns (the second one rolling the cache) on the graph route: one
    warm-up step, one capture, replays after; the ids, pos and cache equal
    the eager session's bit for bit."""
    import importlib

    gm = importlib.import_module("metalchat_tpu_torch.engine.generate")
    parts = fixture["w4a8"]
    params, cfg, tok = parts["port"]
    kw = dict(sampler=GREEDY, max_seq_len=96, max_reply_tokens=24, sink_tokens=4)

    def run(session):
        out = [_turn(session, c) for c in ("def f(x):\n    ", "return x")]
        return out, session.pos

    eager = interp.Interpreter(params, cfg, tok, **kw)
    want = run(eager)
    events = []
    monkeypatch.setattr(ExecutingGraph, "events", events)
    monkeypatch.setattr(gm, "CountedGraph", ExecutingGraph)
    monkeypatch.setattr(interp, "DecodeStep", StandInStep)
    session = interp.Interpreter(params, cfg, tok, **kw)
    assert run(session) == want
    steps = sum(t.decode_steps for t in session.turns)
    assert session.captures == 1 and sum(t.rolls for t in session.turns) >= 1
    assert events == ["capture"] + ["replay"] * (steps - 1)
    assert torch.equal(session.cache.k, eager.cache.k)
    assert torch.equal(session.cache.v, eager.cache.v)
