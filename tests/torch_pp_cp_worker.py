"""One rank of tests/test_torch_pp_cp.py's pipeline- and context-parallel
runs.

Run as ``python torch_pp_cp_worker.py RANK WORLD INIT_FILE INPUTS OUTPUT``:
it joins a gloo group of WORLD ranks through the ``file://`` store
INIT_FILE, reads the parameter trees (numpy, as
`metalchat_tpu_torch.convert.params_from_numpy` takes them), the configs
and the inputs from the pickle INPUTS, runs every case of its group size
(`CASES[WORLD]`) on the CPU and pickles {case: result} to OUTPUT. A case's
single-process reference runs on rank 0, in this process, beside the
parallel run. It imports torch, numpy and the port only.
"""

import ast
import contextlib
import functools
import io
import json
import os
import pickle
import re
import signal
import sys
import threading
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402

from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache  # noqa: E402
from metalchat_tpu_torch.config import LlamaConfig  # noqa: E402
from metalchat_tpu_torch.convert import params_from_numpy  # noqa: E402
from metalchat_tpu_torch.engine.generate import generate  # noqa: E402
from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402
from metalchat_tpu_torch.parallel import (  # noqa: E402
    context_parallel_prefill,
    initialize,
    make_grid_mesh,
    make_pipeline_forward,
    shard_cache_pp,
    shard_params_pp,
    shutdown,
)
from metalchat_tpu_torch.parallel.ring_attention import context_parallel_attention  # noqa: E402

CPU = torch.device("cpu")
F32 = dict(dtype=torch.float32, device=CPU)
# tests/test_pipeline.py's inputs: prefill [4, 8] into a cache of 32.
PIPE_BATCH, PIPE_LEN, PIPE_CACHE = 4, 8, 32
# The int8 case: [2, 8], then decode steps at per-row offsets.
INT8_BATCH, INT8_OFFSETS, INT8_STEPS = 2, [8, 6], 3
PIPE_CASES = {2: [(2, 1, 1), (2, 1, 2)], 4: [(2, 2, 2)]}
# tests/test_parallel_serving.py's runs.
SERVE_CACHE = 96
CP_PROMPT = list(range(1, 41))
CP_NEW = 8
CP_ENGINE_PROMPTS, CP_ENGINE_NEW, CP_THRESHOLD = [list(range(1, 38)), [5, 9, 23]], 6, 16
PP_PROMPT, PP_NEW = [5, 9, 23, 42], 7
PP_ENGINE_PROMPTS, PP_ENGINE_NEW = [[1, 2, 3], [9, 8, 7, 6]], 5
CLI_ARGS = ["--slots", "2", "--max-seq-len", "256", "--device", "cpu"]
# serve --pp 2 --cp 2: the fixture prompt over the engine's 512-token cp
# threshold needs a longer cache.
CLI_LONG_ARGS = ["--slots", "2", "--max-seq-len", "1024", "--device", "cpu"]
HTTP_TIMEOUT_S = 60
HTTP_LONG_NEW = 40  # the request cancelled after its first two tokens


@functools.lru_cache(maxsize=None)
def _grid(*axes):
    """One mesh a shape for the whole run (every rank creates the same
    sub-groups, in the same order)."""
    return make_grid_mesh(dict(axes))


def _pp_mesh(pp, dp=1):
    return _grid(("dp", dp), ("pp", pp))


def _arrays(cache):
    return {n: getattr(cache, n).numpy().copy() for n in cache.__dataclass_fields__}


def _params(data, name):
    return params_from_numpy(data[name], CPU)


def _pipe(data, world, rank, pp, dp, n_mb):
    cfg = LlamaConfig(**data["pipe_cfg"])
    mesh = _pp_mesh(pp, dp)
    params = _params(data, "pipe")
    tokens = torch.tensor(data["pipe_tokens"])
    fwd = make_pipeline_forward(cfg, mesh, n_microbatches=n_mb)
    before = dict(mesh.counts)
    logits, cache = fwd(shard_params_pp(params, mesh),
                        shard_cache_pp(KVCache.create(cfg, PIPE_BATCH, PIPE_CACHE, **F32), mesh),
                        tokens, 0)
    out = {"logits": logits.numpy().copy(), "cache": _arrays(cache),
           "stage": mesh.index("pp"), "row": mesh.index("dp"),
           "collectives": {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                           if v != before.get(k, 0)}}
    if rank == 0:  # the layer route, which a stage runs (8 tokens would take decode_step)
        ref_logits, ref_cache = forward(params, KVCache.create(cfg, PIPE_BATCH, PIPE_CACHE,
                                                               **F32), tokens, 0, cfg,
                                        fast_decode=False)
        out["ref"] = {"logits": ref_logits.numpy().copy(), "cache": _arrays(ref_cache)}
    return out


def _pipe_cases(world):
    def make(pp, dp, n_mb):
        return lambda data, rank: _pipe(data, world, rank, pp, dp, n_mb)
    return {f"pipe_{pp}_{dp}_{n}": make(pp, dp, n) for pp, dp, n in PIPE_CASES[world]}


def case_pipe_int8(data, rank):
    """The W4A8 tree on an int8 cache through pp 2 at 2 microbatches: the
    prefill, then `INT8_STEPS` greedy steps at per-row offsets."""
    cfg = LlamaConfig(**data["pipe_cfg"])
    mesh = _pp_mesh(2)
    fwd = make_pipeline_forward(cfg, mesh, n_microbatches=2)
    params = shard_params_pp(_params(data, "pipe_w4a8"), mesh)
    cache = shard_cache_pp(QuantizedKVCache.create(cfg, INT8_BATCH, PIPE_CACHE, device=CPU),
                           mesh)
    logits, cache = fwd(params, cache, torch.tensor(data["int8_tokens"]), 0)
    steps = [logits.numpy().copy()]
    offsets = torch.tensor(INT8_OFFSETS)
    for _ in range(INT8_STEPS):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, cache = fwd(params, cache, tok, offsets)
        steps.append(logits.numpy().copy())
        offsets = offsets + 1
    return {"logits": steps, "cache": _arrays(cache)}


def _ring(data, world, causal):
    mesh = _grid(("sp", world))
    q, k, v = (torch.tensor(data["ring"][n]) for n in "qkv")
    return context_parallel_attention(q, k, v, mesh, "sp", scale=0.25,
                                      causal=causal).numpy().copy()


def _cp_prefill(data, world, rank, quantized):
    cfg = LlamaConfig(**data["serve_cfg"])
    mesh = _grid(("sp", world))
    b = len(data["cp_tokens"])
    cache = (QuantizedKVCache.create(cfg, b, SERVE_CACHE, device=CPU) if quantized
             else KVCache.create(cfg, b, SERVE_CACHE, **F32))
    params, tokens = _params(data, "serve"), torch.tensor(data["cp_tokens"])
    before = dict(mesh.counts)
    logits, cache = context_parallel_prefill(params, cache, tokens, cfg, mesh)
    out = {"logits": logits.numpy().copy(), "cache": _arrays(cache),
           "collectives": {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                           if v != before.get(k, 0)}}
    if quantized and rank == 0:  # layer 0 of the one-process forward's int8 cache
        _, ref = forward(params, QuantizedKVCache.create(cfg, b, SERVE_CACHE, device=CPU),
                         tokens, 0, cfg)
        s = tokens.shape[1]
        out["ref_layer0"] = {n: getattr(ref, n)[0, ..., :s].numpy().copy()
                             for n in ("k", "v", "k_scale", "v_scale")}
    return out


def _pp_cp_prefill(data, rank, quantized):
    """pp 2 × cp 2 on the same two ranks: the stage-aware
    `context_parallel_prefill` on this rank's stage tree and stage cache,
    and the whole-tree prefill over the same sp ranks. The storage of every
    borrowed layer (what the ``layer_broadcast`` returns, which the layer's
    leaves view) is watched: each must be freed when the next is taken, and
    all of them after."""
    cfg = LlamaConfig(**data["serve_cfg"])
    sp, pp = _grid(("sp", 2)), _pp_mesh(2)
    b = len(data["cp_tokens"])

    def cache():
        return (QuantizedKVCache.create(cfg, b, SERVE_CACHE, device=CPU) if quantized
                else KVCache.create(cfg, b, SERVE_CACHE, **F32))

    params, tokens = _params(data, "serve"), torch.tensor(data["cp_tokens"])
    whole_logits, whole = context_parallel_prefill(params, cache(), tokens, cfg, sp)
    local = shard_params_pp(params, pp)
    stage_cache = shard_cache_pp(cache(), pp)
    borrowed, early = [], []
    real = sp.broadcast

    def watched(t, axis, src, kind="broadcast"):
        if kind == "layer_broadcast":
            early.append(sum(not r.expired() for r in borrowed))
        out = real(t, axis, src, kind)
        if kind == "layer_broadcast":
            borrowed.append(StorageWeakRef(out.untyped_storage()))
        return out

    sp.broadcast = watched
    before = dict(sp.counts)
    try:
        logits, _ = context_parallel_prefill(local, stage_cache, tokens, cfg, sp, stages=pp)
    finally:
        del sp.broadcast
    stage, per = pp.index("pp"), cfg.num_layers // 2
    return {"logits": logits.numpy().copy(), "whole_logits": whole_logits.numpy().copy(),
            "cache": _arrays(stage_cache),
            "whole_stage": {n: a[stage * per:(stage + 1) * per] for n, a in _arrays(whole).items()},
            "collectives": {k: v - before.get(k, 0) for k, v in sp.counts.items()
                            if v != before.get(k, 0)},
            "borrowed": len(borrowed), "alive_at_next": early,
            "alive_after": sum(not r.expired() for r in borrowed),
            "stage_layers": {k: v.shape[0] for k, v in local["layers"].items()}}


def case_pp_cp_serving(data, rank):
    """`generate` and the engine with the pipeline forward (pp 2) and a
    context-parallel mesh over the same two ranks."""
    cfg = LlamaConfig(**data["serve_cfg"])
    pp, sp = _pp_mesh(2), _grid(("sp", 2))
    local = shard_params_pp(_params(data, "serve"), pp)
    fwd = make_pipeline_forward(cfg, pp, n_microbatches=1)
    out = {"generate": generate(local, cfg, torch.tensor([CP_PROMPT]), max_new_tokens=CP_NEW,
                                forward_fn=fwd, context_parallel_mesh=sp,
                                cache=shard_cache_pp(KVCache.create(cfg, 1, SERVE_CACHE, **F32),
                                                     pp)).tolist()}
    engine = ContinuousBatchingEngine(
        local, cfg, max_slots=2, max_seq_len=SERVE_CACHE, forward_fn=fwd,
        cache=shard_cache_pp(KVCache.create(cfg, 2, SERVE_CACHE, **F32), pp),
        context_parallel_mesh=sp, context_parallel_threshold=CP_THRESHOLD)
    out["engine"] = _engine_tokens(engine, CP_ENGINE_PROMPTS, CP_ENGINE_NEW)
    out["engine_cp_prefills"] = dict(engine.cp_prefill_shapes)
    return out


def case_http_follow(data, rank):
    """`InferenceServer(mesh=)` on rank 0 and `follow` on rank 1 over the
    pipeline (pp 2) engine, without HTTP traffic: a long request and a short
    one submitted, the long one cancelled once it has two tokens. Each
    rank's completions afterwards."""
    from metalchat_tpu_torch.engine.http import InferenceServer, follow
    from metalchat_tpu_torch.sampling import SamplerConfig

    cfg = LlamaConfig(**data["serve_cfg"])
    pp = _pp_mesh(2)
    engine = ContinuousBatchingEngine(
        shard_params_pp(_params(data, "serve"), pp), cfg, max_slots=2,
        max_seq_len=SERVE_CACHE, forward_fn=make_pipeline_forward(cfg, pp),
        cache=shard_cache_pp(KVCache.create(cfg, 2, SERVE_CACHE, **F32), pp))
    if rank != 0:
        follow(engine, pp)
    else:
        server = InferenceServer(engine, None, mesh=pp)
        server.start(port=0)
        try:
            long = server.submit(CP_PROMPT, HTTP_LONG_NEW, SamplerConfig.greedy(), ())
            short = server.submit(PP_PROMPT, PP_NEW, SamplerConfig.greedy(), ())
            tokens = server.iter_tokens(long)
            next(tokens), next(tokens)
            server.cancel(long)
            tokens.close()
            server.collect(short)
        finally:
            server.stop()
    return [(c.tokens, c.finish_reason) for c in engine._completions.values()]


def _engine_tokens(engine, prompts, new):
    out = engine.run([Request(prompt=p, max_new_tokens=new) for p in prompts])
    return [c.tokens for c in out.values()]


def _cp_serving(data, world, rank):
    """`generate` and the engine with a context-parallel mesh, and (rank 0)
    their one-process runs."""
    cfg = LlamaConfig(**data["serve_cfg"])
    mesh = _grid(("sp", world))
    params = _params(data, "serve")
    prompt = torch.tensor([CP_PROMPT])
    out = {"generate": generate(params, cfg, prompt, max_new_tokens=CP_NEW,
                                cache=KVCache.create(cfg, 1, SERVE_CACHE, **F32),
                                context_parallel_mesh=mesh).tolist()}
    engine = ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=SERVE_CACHE,
                                      context_parallel_mesh=mesh,
                                      context_parallel_threshold=CP_THRESHOLD)
    out["engine"] = _engine_tokens(engine, CP_ENGINE_PROMPTS, CP_ENGINE_NEW)
    out["engine_cp_prefills"] = dict(engine.cp_prefill_shapes)
    if rank == 0:
        out["ref_generate"] = generate(params, cfg, prompt, max_new_tokens=CP_NEW,
                                       cache=KVCache.create(cfg, 1, SERVE_CACHE, **F32)).tolist()
        out["ref_engine"] = _engine_tokens(
            ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=SERVE_CACHE),
            CP_ENGINE_PROMPTS, CP_ENGINE_NEW)
    return out


def case_pp_serving(data, rank):
    """`generate` and the engine with the pipeline forward (pp 2), and
    (rank 0) their one-process runs."""
    cfg = LlamaConfig(**data["serve_cfg"])
    mesh = _pp_mesh(2)
    params = _params(data, "serve")
    local = shard_params_pp(params, mesh)
    fwd = make_pipeline_forward(cfg, mesh, n_microbatches=1)
    prompt = torch.tensor([PP_PROMPT])
    out = {"generate": generate(local, cfg, prompt, max_new_tokens=PP_NEW, forward_fn=fwd,
                                cache=shard_cache_pp(KVCache.create(cfg, 1, SERVE_CACHE, **F32),
                                                     mesh)).tolist()}
    engine = ContinuousBatchingEngine(
        local, cfg, max_slots=2, max_seq_len=SERVE_CACHE, forward_fn=fwd,
        cache=shard_cache_pp(KVCache.create(cfg, 2, SERVE_CACHE, **F32), mesh))
    out["engine"] = _engine_tokens(engine, PP_ENGINE_PROMPTS, PP_ENGINE_NEW)
    if rank == 0:
        out["ref_generate"] = generate(params, cfg, prompt, max_new_tokens=PP_NEW,
                                       cache=KVCache.create(cfg, 1, SERVE_CACHE, **F32)).tolist()
        out["ref_engine"] = _engine_tokens(
            ContinuousBatchingEngine(params, cfg, max_slots=2, max_seq_len=SERVE_CACHE),
            PP_ENGINE_PROMPTS, PP_ENGINE_NEW)
    return out


def _cli(data, flags, inputs=None, args=CLI_ARGS):
    """`serve` with ``flags`` (e.g. ``--pp 2``) of the port's CLI in this
    rank's process (the group is up: the CLI joins it and checks its size)
    on the JSONL ``inputs`` (default: the fixture's PROMPT): rank 0's JSONL
    lines and its served-requests summary (stderr)."""
    from metalchat_tpu_torch.cli.main import main

    os.environ["METALCHAT_TPU_HOME"] = data["cli_home"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["serve", "pyllama", "--input", inputs or data["cli_input"], *args, *flags])
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    summary = re.search(r"served \d+ requests: (\{.*\})", err.getvalue())
    return {"rc": rc, "lines": lines,
            "summary": ast.literal_eval(summary.group(1)) if summary else None}


class _Listening(io.StringIO):
    """stderr that hands the CLI's "listening on" port to a waiting thread."""

    def __init__(self):
        super().__init__()
        self.port = None
        self.ready = threading.Event()

    def write(self, text):
        found = re.search(r"listening on http://[\d.]+:(\d+)", text)
        if found:
            self.port = int(found.group(1))
            self.ready.set()
        return super().write(text)


def _post_then_interrupt(err: _Listening, prompts, answers: list) -> None:
    """Rank 0's client: each (prompt, max_tokens) to /v1/completions in
    turn, then SIGINT to this process, which the CLI takes as its stop."""
    try:
        if err.ready.wait(HTTP_TIMEOUT_S):
            for prompt, n in prompts:
                body = json.dumps({"prompt": prompt, "max_tokens": n,
                                   "temperature": 0.0}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{err.port}/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
                    answers.append(json.loads(r.read())["choices"][0]["text"])
    finally:
        os.kill(os.getpid(), signal.SIGINT)


def case_http_pp_cp(data, rank):
    """`serve --pp 2 --cp 2 --http 0`: rank 0 serves HTTP, posts the
    prompts to itself and stops the server; rank 1 follows. Each rank's
    exit code and rank 0's answers."""
    from metalchat_tpu_torch.cli.main import main

    os.environ["METALCHAT_TPU_HOME"] = data["cli_home"]
    argv = ["serve", "pyllama", *CLI_LONG_ARGS, "--pp", "2", "--cp", "2", "--http", "0"]
    if rank != 0:
        return {"rc": main(argv), "answers": []}
    signal.signal(signal.SIGINT, signal.default_int_handler)
    err, answers = _Listening(), []
    client = threading.Thread(target=_post_then_interrupt,
                              args=(err, data["http_prompts"], answers), daemon=True)
    client.start()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    client.join(HTTP_TIMEOUT_S)
    return {"rc": rc, "answers": answers}


CASES = {
    2: {**_pipe_cases(2), "pipe_int8": case_pipe_int8,
        **{f"ring_{c}": functools.partial(lambda d, r, c: _ring(d, 2, c), c=c)
           for c in (True, False)},
        **{f"cp_prefill_{q}": functools.partial(lambda d, r, q: _cp_prefill(d, 2, r, q), q=q)
           for q in (False, True)},
        "cp_serving": lambda d, r: _cp_serving(d, 2, r),
        "pp_serving": case_pp_serving,
        "cli": lambda d, r: _cli(d, ["--pp", "2"]),
        **{f"pp_cp_prefill_{q}": functools.partial(lambda d, r, q: _pp_cp_prefill(d, r, q), q=q)
           for q in (False, True)},
        "pp_cp_serving": case_pp_cp_serving,
        "cli_pp_cp_short": lambda d, r: _cli(d, ["--pp", "2", "--cp", "2"], args=CLI_LONG_ARGS),
        "cli_pp_cp_long": lambda d, r: _cli(d, ["--pp", "2", "--cp", "2"], d["cli_long_input"],
                                            CLI_LONG_ARGS),
        "http_pp_cp": case_http_pp_cp,
        "http_follow": case_http_follow},
    4: {**_pipe_cases(4),
        **{f"ring_{c}": functools.partial(lambda d, r, c: _ring(d, 4, c), c=c)
           for c in (True, False)},
        **{f"cp_prefill_{q}": functools.partial(lambda d, r, q: _cp_prefill(d, 4, r, q), q=q)
           for q in (False, True)},
        "cp_serving": lambda d, r: _cp_serving(d, 4, r),
        "cli": lambda d, r: _cli(d, ["--cp", "4"])},
}


def main(argv) -> int:
    rank, world, init_file, inputs, output = (int(argv[1]), int(argv[2]), argv[3], argv[4],
                                              argv[5])
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
               timeout_s=90)
    try:
        with open(inputs, "rb") as f:
            data = pickle.load(f)
        with torch.no_grad():
            results = {name: fn(data, rank) for name, fn in CASES[world].items()}
        with open(output, "wb") as f:
            pickle.dump(results, f)
    finally:
        shutdown()
    print(f"OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
