"""The port's OpenAI-compatible HTTP server (metalchat_tpu_torch/engine/http.py)
over the port's engine on the CPU: real sockets on 127.0.0.1, the trained
fixture quantized W4A8 with paged int8 KV, and a byte-level tokenizer.

Blocking text, the SSE stream's text and the engine's own tokens for the
same prompt agree; chat, /health, /v1/models, /metrics, a 400 on a request
without a prompt, and a request timeout that returns the partial text.
Every request carries a timeout and the fixture stops the servers.
"""

import json
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from chip_smoke import ByteTokenizer
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.engine import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.engine.http import InferenceServer
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.models.fuse import fuse_projections
from metalchat_tpu_torch.quant.quantize import quantize_params

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
ENGINE = dict(max_slots=3, max_seq_len=128, prefill_chunk=32, decode_burst=4,
              cache_mode="paged", page_size=16)


@pytest.fixture(scope="module")
def model():
    cfg = load_config(FIXTURE / "config.json")
    params = load_params(open_safetensors(FIXTURE), cfg, dtype=torch.float32,
                         max_seq_len=128, device="cpu")
    return fuse_projections(quantize_params(params, bits=4, group_size=None, act_bits=8),
                            cfg), cfg


@pytest.fixture(scope="module")
def server(model):
    engine = ContinuousBatchingEngine(*model, **ENGINE)
    srv = InferenceServer(engine, ByteTokenizer(), model_name="fixture")
    port = srv.start()
    yield srv, port
    srv.stop()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _sse_text(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps({**payload, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            chunks.append(json.loads(line[len("data: "):])["choices"][0]["text"])
    return "".join(chunks)


def test_blocking_sse_and_engine_agree(model, server):
    _, port = server
    payload = {"prompt": "The history of the ", "max_tokens": 12}
    status, out = _post(port, "/v1/completions", payload)
    assert status == 200 and out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    text = out["choices"][0]["text"]
    assert _sse_text(port, payload) == text

    engine = ContinuousBatchingEngine(*model, **ENGINE)
    req = Request(prompt=ByteTokenizer().encode(payload["prompt"]), max_new_tokens=12)
    tokens = engine.run([req])[req.request_id].tokens
    assert len(tokens) == 12 and ByteTokenizer().decode(tokens) == text


def test_chat_completion(server):
    _, port = server
    status, out = _post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
    assert status == 200 and out["object"] == "chat.completion"
    choice = out["choices"][0]
    assert choice["message"]["role"] == "assistant" and choice["finish_reason"] == "length"


def test_missing_prompt_is_a_400(server):
    _, port = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, "/v1/completions", {"max_tokens": 4})
    assert err.value.code == 400 and "error" in json.loads(err.value.read())


def test_health_models_and_metrics(server):
    _, port = server
    assert _get(port, "/health") == (200, {"status": "ok"})
    assert _get(port, "/v1/models")[1]["data"][0]["id"] == "fixture"
    _post(port, "/v1/completions", {"prompt": "metrics", "max_tokens": 2})
    status, metrics = _get(port, "/metrics")
    assert status == 200 and metrics["requests"] >= 1
    assert {"prefill_dispatches", "decode_steps", "ttft_p50"} <= set(metrics)


def test_request_timeout_returns_partial(model):
    engine = ContinuousBatchingEngine(*model, **ENGINE)
    srv = InferenceServer(engine, ByteTokenizer(), request_timeout=0.02)
    port = srv.start()
    try:
        status, body = _post(port, "/v1/completions", {"prompt": "hello", "max_tokens": 100})
        assert status == 200 and body["choices"][0]["finish_reason"] == "timeout"
        assert len(body["choices"][0]["text"]) < 100
        assert not engine.has_work  # the slot was freed
    finally:
        srv.stop()
