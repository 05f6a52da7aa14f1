"""Chat interpreter, the conversational decode loop (port of the JAX
package's ``chat/interpreter.py``).

A session buffers encoded message tokens (the template's begin text once),
`write` renders a mustache template with declared variables and the tool
builtins, `read` flushes the buffer through one prefill and then decodes
one token at a time until a scanner stops it, and `exec` runs the
read → tool call → ipython result loop. The KV cache persists across turns.

The JAX loop is one jitted `forward` a token. Here a session keeps one
`engine.generate.DecodeState` and one `DecodeStep` for its whole life: each
turn's prefill is one eager `forward` (flash attention for more than 16
tokens, at the session's position), after which the sampled token and the
position are written into the state's tensors in place; every reply token
is then one step of the same `DecodeStep`, which on the card captures one
CUDA graph for the session and replays it (turn after turn, and after the
cache rolls in place). One host read a token, the sampled id, feeds the
scanners, as in `generate_stream`. The accounting is the JAX package's:
the stop token goes into the next flush, the context check in `_flush`, and
with ``sink_tokens`` the cache rolls by ``(max_seq_len - sink_tokens) //
4`` when it fills.

Token ids are checked on the host before each prefill: an id the model
cannot embed raises `ValueError` (the JAX gather clamps it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch

from metalchat_tpu_torch.cache import KVCache, roll_kv_cache
from metalchat_tpu_torch.chat.scanners import (
    CompositeScanner,
    LimitScanner,
    StopTokenScanner,
    TokenScanner,
)
from metalchat_tpu_torch.chat.template import render_template
from metalchat_tpu_torch.chat.tools import COMMAND_FORMAT, Command, CommandScanner
from metalchat_tpu_torch.config import ModelConfig
from metalchat_tpu_torch.engine.generate import DecodeState, DecodeStep
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.sampling import SamplerConfig, sample
from metalchat_tpu_torch.text.tokenizer import StreamingDecoder, TokenKind


@dataclass(frozen=True)
class ChatTemplates:
    """Message rendering templates (mustache)."""

    begin_text: str
    header: str      # vars: role
    message: str     # vars: role, content (+ declared vars, metalchat.*)

    @staticmethod
    def llama3() -> "ChatTemplates":
        return ChatTemplates(
            begin_text="<|begin_of_text|>",
            header="<|start_header_id|>{{role}}<|end_header_id|>\n\n",
            message=(
                "<|start_header_id|>{{role}}<|end_header_id|>\n\n"
                "{{content}}<|eot_id|>"
            ),
        )

    @staticmethod
    def gemma3() -> "ChatTemplates":
        return ChatTemplates(
            begin_text="<bos>",
            header="<start_of_turn>{{role}}\n",
            message="<start_of_turn>{{role}}\n{{content}}<end_of_turn>\n",
        )


@dataclass
class TurnStats:
    """One read: the prefill, the reply and their host-clock times."""

    start_pos: int            # cache fill before the prefill
    prefill_tokens: int
    ttft_s: float = 0.0       # read start → first token on the host
    decode_steps: int = 0     # reply tokens yielded (one step each)
    decode_s: float = 0.0     # first token → the step after the last
    rolls: int = 0            # sink rolls of the cache

    @property
    def decode_tok_s(self) -> Optional[float]:
        return self.decode_steps / self.decode_s if self.decode_s > 0 else None


class Interpreter:
    """Single-session chat loop with a persistent KV cache, on the device
    of the parameters (a dense cache in their dtype)."""

    def __init__(
        self,
        params,
        config: ModelConfig,
        tokenizer,
        *,
        templates: Optional[ChatTemplates] = None,
        sampler: SamplerConfig = SamplerConfig(),
        max_seq_len: Optional[int] = None,
        max_reply_tokens: int = 512,
        commands: Optional[Sequence[Command]] = None,
        scanner: Optional[TokenScanner] = None,
        assistant_role: str = "assistant",
        sink_tokens: Optional[int] = None,
        seed: int = 0,
    ):
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.templates = templates or ChatTemplates.llama3()
        self.sampler = sampler
        self.max_seq_len = max_seq_len or config.max_seq_len
        self.max_reply_tokens = max_reply_tokens
        self.assistant_role = assistant_role
        self.sink_tokens = sink_tokens
        self.commands = CommandScanner(list(commands) if commands else [])
        self.variables: Dict[str, Any] = {}
        # HF Jinja2 templates (chat/hf_template.py HFChatTemplates) render
        # whole conversations; the session tracks messages + the canonical
        # rendered text so each write emits only the delta.
        self._hf = hasattr(self.templates, "render_message_delta")
        self._messages: List[Dict[str, str]] = []
        self._hf_emitted = ""

        device = params["final_norm"].device
        self.cache = KVCache.create(config, 1, self.max_seq_len,
                                    dtype=params["final_norm"].dtype, device=device)
        self.pos = 0  # tokens already in the cache (the host's copy of state.pos)
        self._buffer: List[int] = []
        self.turns: List[TurnStats] = []
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        self._state = DecodeState(
            cache=self.cache, last_tokens=torch.zeros(1, dtype=torch.int64, device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device), generator=generator,
            done=torch.zeros(1, dtype=torch.bool, device=device))
        # No EOS ids in the step: the host's scanners end a turn.
        self._step = DecodeStep(config, sampler)
        self._write_text(self.templates.begin_text)

        specials = getattr(tokenizer, "specials", None)
        stop_kinds = TokenKind.END_TEXT | TokenKind.END_TURN | TokenKind.END_MESSAGE
        stop_ids = specials.ids_with_kind(stop_kinds) if specials else []
        self.stop_ids = frozenset(stop_ids)
        self.scanner = scanner or CompositeScanner(
            [StopTokenScanner(stop_ids), LimitScanner(max_reply_tokens)]
        )

    @property
    def captures(self) -> int:
        """CUDA graphs the session's decode step captured (one a session on
        the card, none on the CPU)."""
        return self._step.captures

    # -- session variables / tools ----------------------------------------

    def declare(self, name: str, value: Any) -> None:
        """Declare a template variable."""
        self.variables[name] = value

    def register_command(self, command: Command) -> None:
        self.commands.register(command)

    # -- writing -----------------------------------------------------------

    def _template_scope(self, **extra: Any) -> Dict[str, Any]:
        scope = dict(self.variables)
        scope.update(extra)
        scope["metalchat"] = {
            "commands": self.commands.describe_all(),
            "command_format": COMMAND_FORMAT,
        }
        return scope

    def _write_text(self, text: str) -> None:
        if text:
            self._buffer.extend(self.tokenizer.encode(text, allow_special=True))

    def write(self, content: str, role: str = "user") -> None:
        """Render + encode one chat message into the pending buffer."""
        self._messages.append({"role": role, "content": content})
        if self._hf:
            full = self.templates._render(self._messages, False)
            if full.startswith(self._hf_emitted):
                text = full[len(self._hf_emitted):]
            else:  # template rewrote earlier text (e.g. trimmed a reply):
                # emit only this message's delta and resync the baseline.
                text = self.templates.render_message_delta(self._messages)
            self._hf_emitted = full
        else:
            text = render_template(
                self.templates.message,
                self._template_scope(role=role, content=content),
            )
        self._write_text(text)

    def write_header(self, role: str) -> None:
        if self._hf:
            text = self.templates.render_generation_header(self._messages)
            self._hf_emitted += text
        else:
            text = render_template(self.templates.header,
                                   self._template_scope(role=role))
        self._write_text(text)

    def _record_reply(self, text: str) -> None:
        """Track a finished assistant reply so the next HF-template delta
        renders against the full conversation (mustache mode: KV is the only
        history, nothing to track)."""
        self._messages.append({"role": self.assistant_role, "content": text})
        if self._hf:
            stop_text = ""
            if self._buffer and self._buffer[-1] in self.stop_ids:
                try:
                    stop_text = self.tokenizer.decode([self._buffer[-1]])
                except Exception:
                    stop_text = ""
            self._hf_emitted += text + stop_text

    # -- reading -----------------------------------------------------------

    def _check_ids(self, ids: Sequence[int]) -> None:
        vocab = self.config.vocab_size
        for t in ids:
            if not 0 <= t < vocab:
                specials = getattr(self.tokenizer, "specials", None)
                special = specials.by_id(t) if specials else None
                text = special.text if special else self.tokenizer.decode([t])
                raise ValueError(f"token id {t} ({text!r}) is outside the model's "
                                 f"vocabulary of {vocab}")

    @torch.no_grad()
    def _flush(self) -> int:
        """Prefill all buffered tokens into the cache at ``pos``; sets the
        decode state to the first sampled token and returns it."""
        if not self._buffer:
            raise RuntimeError("nothing to flush — write a message first")
        if self.pos + len(self._buffer) >= self.max_seq_len:
            raise RuntimeError("context window exhausted")
        self._check_ids(self._buffer)
        state = self._state
        tokens = torch.tensor([self._buffer], dtype=torch.int64,
                              device=state.last_tokens.device)
        logits, _ = forward(self.params, self.cache, tokens, self.pos, self.config)
        self.pos += len(self._buffer)
        self._buffer.clear()
        state.last_tokens.copy_(sample(logits[:, -1], state.generator, self.sampler))
        state.pos.fill_(self.pos)
        return int(state.last_tokens[0])

    def read_tokens(self) -> Iterator[int]:
        """Decode assistant tokens until a scanner stops (EOS ids included)."""
        self.write_header(self.assistant_role)
        self.scanner.reset()
        t0 = time.perf_counter()
        stats = TurnStats(start_pos=self.pos, prefill_tokens=len(self._buffer))
        self.turns.append(stats)
        token = self._flush()
        t1 = time.perf_counter()
        stats.ttft_s = t1 - t0
        state = self._state
        while True:
            exhausted = self.pos + 1 >= self.max_seq_len
            if exhausted and self.sink_tokens is not None:
                # Attention-sinks eviction, in place: the captured step
                # replays on the same tensors.
                shift = max(1, (self.max_seq_len - self.sink_tokens) // 4)
                roll_kv_cache(self.cache, self.sink_tokens, shift)
                state.pos.sub_(shift)
                self.pos -= shift
                stats.rolls += 1
                exhausted = False
            if not self.scanner.scan(token) or exhausted:
                # Account the stop token into the context then end the turn.
                if token in self.stop_ids:
                    self._buffer.append(token)
                return
            yield token
            t = time.perf_counter()
            self._step.advance(self.params, state)
            self.pos += 1
            token = int(state.last_tokens[0])
            stats.decode_s += time.perf_counter() - t
            stats.decode_steps += 1

    def read_stream(self) -> Iterator[str]:
        decoder = StreamingDecoder(self.tokenizer)
        parts: List[str] = []
        for token in self.read_tokens():
            chunk = decoder.feed(token)
            if chunk:
                parts.append(chunk)
                yield chunk
        tail = decoder.flush()
        if tail:
            parts.append(tail)
            yield tail
        self._record_reply("".join(parts))

    def read(self) -> str:
        return "".join(self.read_stream())

    # -- tool-calling loop --------------------------------------------------

    def exec(self, content: str, role: str = "user", max_rounds: int = 4) -> str:
        """write → read → (tool call → ipython result → read)* → final text."""
        self.write(content, role=role)
        for _ in range(max_rounds):
            text = self.read()
            statement = self.commands.parse(text)
            if statement is None:
                return text
            try:
                result = self.commands.execute(statement)
            except Exception as exc:  # tool failures go back to the model
                result = f"error: {exc}"
            self.write(str(result), role="ipython")
        return text


ChatSession = Interpreter
