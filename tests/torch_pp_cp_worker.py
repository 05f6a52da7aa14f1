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

import contextlib
import functools
import io
import json
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

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


def _cli(data, flag, world):
    """`serve --pp/--cp WORLD` of the port's CLI in this rank's process (the
    group is up: the CLI joins it and checks its size); rank 0's JSONL."""
    from metalchat_tpu_torch.cli.main import main

    os.environ["METALCHAT_TPU_HOME"] = data["cli_home"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["serve", "pyllama", "--input", data["cli_input"], *CLI_ARGS, flag,
                   str(world)])
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    return {"rc": rc, "lines": lines}


CASES = {
    2: {**_pipe_cases(2), "pipe_int8": case_pipe_int8,
        **{f"ring_{c}": functools.partial(lambda d, r, c: _ring(d, 2, c), c=c)
           for c in (True, False)},
        **{f"cp_prefill_{q}": functools.partial(lambda d, r, q: _cp_prefill(d, 2, r, q), q=q)
           for q in (False, True)},
        "cp_serving": lambda d, r: _cp_serving(d, 2, r),
        "pp_serving": case_pp_serving,
        "cli": lambda d, r: _cli(d, "--pp", 2)},
    4: {**_pipe_cases(4),
        **{f"ring_{c}": functools.partial(lambda d, r, c: _ring(d, 4, c), c=c)
           for c in (True, False)},
        **{f"cp_prefill_{q}": functools.partial(lambda d, r, q: _cp_prefill(d, 4, r, q), q=q)
           for q in (False, True)},
        "cp_serving": lambda d, r: _cp_serving(d, 4, r),
        "cli": lambda d, r: _cli(d, "--cp", 4)},
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
