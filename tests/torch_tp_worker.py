"""One rank of tests/test_torch_tp.py's tensor-parallel runs.

Run as ``python torch_tp_worker.py RANK WORLD INIT_FILE INPUTS OUTPUT``: it
joins a gloo group through the ``file://`` store INIT_FILE, reads the
parameter trees (numpy, as `metalchat_tpu_torch.convert.params_from_numpy`
takes them) and the config from the pickle INPUTS, runs every case of
`CASES` on the CPU and pickles {case: result} to OUTPUT. It imports torch,
numpy and the port only.
"""

import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import metalchat_tpu_torch.config as tconfig  # noqa: E402
from metalchat_tpu_torch.cache import KVCache, PagedKVCache, QuantizedKVCache  # noqa: E402
from metalchat_tpu_torch.config import LlamaConfig  # noqa: E402
from metalchat_tpu_torch.convert import params_from_numpy  # noqa: E402
from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402
from metalchat_tpu_torch.parallel import (  # noqa: E402
    MultiHostEngine,
    initialize,
    make_mesh,
    make_tp_decode_step,
    shard_cache,
    shard_params,
    shutdown,
)
from metalchat_tpu_torch.sampling import SamplerConfig  # noqa: E402

CPU = torch.device("cpu")
# The JAX tests' decode inputs (tests/test_tp_decode.py).
TOKENS = [[5], [9]]
POSITIONS = [3, 7]
GREEDY_STEPS = 8
PAGED = dict(num_pages=8, page_size=64, max_slots=2)
PAGE_TABLE = [[0, 1, 2, 3], [4, 5, 6, 7]]
ENGINE = dict(max_slots=4, max_seq_len=64, decode_burst=4, prefill_chunk=16)
ENGINE_MODES = {"dense": {}, "paged": dict(cache_mode="paged", page_size=32)}
REQUESTS = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 5)]
SAMPLED = SamplerConfig(temperature=0.8, top_k=20, top_p=0.9)
# The layer route's leaf kinds: a prompt, then this token, through
# forward(..., tp=mesh); the engine on the trees of LEAF_ENGINES.
STEP_TOKEN = [[7]]
LEAF_ENGINES = ("dense_fused", "int4_fused_t", "gpt2_fused", "lora")


def _cache_arrays(cache):
    return {n: getattr(cache, n).numpy().copy() for n in cache.__dataclass_fields__}


def _local(data, name, cfg, mesh):
    return shard_params(params_from_numpy(data[name], CPU), cfg, mesh)


def case_dense_greedy(data, cfg, mesh):
    """8 greedy tensor-parallel steps of the dense f32 model from position 0."""
    params = _local(data, "dense", cfg, mesh)
    cache = shard_cache(KVCache.create(cfg, 2, cfg.max_seq_len, dtype=torch.float32,
                                       device=CPU), mesh)
    step = make_tp_decode_step(params, cfg, mesh)
    tok, pos = torch.tensor(TOKENS), torch.zeros(2, dtype=torch.int32)
    first, ids = None, []
    for _ in range(GREEDY_STEPS):
        logits, cache = step(params, cache, tok, pos)
        first = logits.numpy().copy() if first is None else first
        tok = logits[:, -1].argmax(-1)[:, None]
        ids.append(tok[:, 0].numpy().copy())
        pos = pos + 1
    return {"logits": first, "ids": np.stack(ids)}


def _one_step(data, name, cfg, mesh, cache):
    params = _local(data, name, cfg, mesh)
    step = make_tp_decode_step(params, cfg, mesh)
    before = dict(mesh.counts)
    logits, cache = step(params, shard_cache(cache, mesh), torch.tensor(TOKENS),
                         torch.tensor(POSITIONS, dtype=torch.int32))
    counts = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
              if v != before.get(k, 0)}
    return {"logits": logits.numpy().copy(), "cache": _cache_arrays(cache),
            "collectives": counts}


def case_w4a8_step(data, cfg, mesh):
    return _one_step(data, "w4a8", cfg, mesh, QuantizedKVCache.create(
        cfg, 2, cfg.max_seq_len, device=CPU))


def case_fused_step(data, cfg, mesh):
    return _one_step(data, "fused", cfg, mesh, QuantizedKVCache.create(
        cfg, 2, cfg.max_seq_len, device=CPU))


def case_paged_step(data, cfg, mesh):
    cache = PagedKVCache.create(cfg, **PAGED, device=CPU)
    cache.page_table.copy_(torch.tensor(PAGE_TABLE, dtype=torch.int32))
    return _one_step(data, "w4a8", cfg, mesh, cache)


def _prefill(data, name, cfg, mesh, cache):
    params = _local(data, name, cfg, mesh)
    logits, cache = forward(params, shard_cache(cache, mesh),
                            torch.tensor(data["prompt"]), 0, cfg, tp=mesh)
    return {"logits": logits.numpy().copy(), "cache": _cache_arrays(cache)}


def case_prefill_fused(data, cfg, mesh):
    return _prefill(data, "fused", cfg, mesh, QuantizedKVCache.create(
        cfg, 1, cfg.max_seq_len, device=CPU))


def case_prefill_w4a8(data, cfg, mesh):
    return _prefill(data, "w4a8", cfg, mesh, QuantizedKVCache.create(
        cfg, 1, cfg.max_seq_len, device=CPU))


def case_prefill_dense(data, cfg, mesh):
    return _prefill(data, "dense", cfg, mesh, KVCache.create(
        cfg, 1, cfg.max_seq_len, dtype=torch.float32, device=CPU))


def _engine_run(data, cfg, mesh, mode):
    engine = ContinuousBatchingEngine(_local(data, "dense", cfg, mesh), cfg, spmd_mesh=mesh,
                                      **ENGINE, **ENGINE_MODES[mode])
    out = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in REQUESTS])
    return {"tokens": [c.tokens for c in out.values()],
            "finished": [c.finished and c.error is None for c in out.values()],
            "collectives": engine.forward_fn.collectives}


def case_engine_dense(data, cfg, mesh):
    return _engine_run(data, cfg, mesh, "dense")


def case_engine_paged(data, cfg, mesh):
    return _engine_run(data, cfg, mesh, "paged")


def case_multihost(data, cfg, mesh):
    """Rank 0 holds the requests, rank 1 passes None; one request samples."""
    engine = MultiHostEngine(params_from_numpy(data["dense"], CPU), cfg, mesh, seed=7,
                             **ENGINE, **ENGINE_MODES["paged"])
    requests = None
    if mesh.rank == 0:
        requests = [Request(prompt=p, max_new_tokens=n) for p, n in REQUESTS]
        requests.append(Request(prompt=[11, 12, 13, 14], max_new_tokens=7, sampler=SAMPLED))
    out = engine.run(requests)
    return {"tokens": [c.tokens for c in out.values()],
            "finished": [c.finished and c.error is None for c in out.values()]}


def _leaf_cfg(entry):
    kind, fields = entry["cfg"]
    return getattr(tconfig, kind)(**fields)


def case_leaves(data, cfg, mesh):
    """Every tree of ``data["leaves"]`` (dense fused, group-wise int4 and int8
    in both orientations, fused and not, GPT-2 with biases and an odd
    vocabulary, LoRA) on the sharded layer route: the prompt's logits, then
    one token's, and the collectives of the two calls."""
    out = {}
    for name, entry in data["leaves"].items():
        lcfg = _leaf_cfg(entry)
        params = shard_params(params_from_numpy(entry["tree"], CPU), lcfg, mesh)
        cache = shard_cache(KVCache.create(lcfg, 1, lcfg.max_seq_len, dtype=torch.float32,
                                           device=CPU), mesh)
        prompt = torch.tensor(entry["prompt"])
        before = dict(mesh.counts)
        prefill, cache = forward(params, cache, prompt, 0, lcfg, tp=mesh)
        step, _ = forward(params, cache, torch.tensor(STEP_TOKEN), prompt.shape[1], lcfg,
                          tp=mesh)
        out[name] = {"prefill": prefill.numpy().copy(), "step": step.numpy().copy(),
                     "collectives": {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                                     if v != before.get(k, 0)}}
    return out


def case_engine_leaves(data, cfg, mesh):
    """The engine (``spmd_mesh``, dense f32 cache) on the trees the fast
    decode refuses: tokens and the route `spmd_forward_fn` picked."""
    out = {}
    for name in LEAF_ENGINES:
        entry = data["leaves"][name]
        lcfg = _leaf_cfg(entry)
        engine = ContinuousBatchingEngine(
            shard_params(params_from_numpy(entry["tree"], CPU), lcfg, mesh), lcfg,
            spmd_mesh=mesh, **ENGINE)
        done = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in REQUESTS])
        out[name] = {"tokens": [c.tokens for c in done.values()],
                     "finished": [c.finished and c.error is None for c in done.values()],
                     "route": engine.forward_fn.__qualname__.split(".")[0]}
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


def main(argv) -> int:
    rank, world, init_file, inputs, output = (int(argv[1]), int(argv[2]), argv[3], argv[4],
                                              argv[5])
    torch.set_num_threads(2)
    initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
               timeout_s=90)
    try:
        mesh = make_mesh()
        with open(inputs, "rb") as f:
            data = pickle.load(f)
        cfg = LlamaConfig(**data["cfg"])
        with torch.no_grad():
            results = {name: fn(data, cfg, mesh) for name, fn in CASES.items()}
        with open(output, "wb") as f:
            pickle.dump(results, f)
    finally:
        shutdown()
    print(f"OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
