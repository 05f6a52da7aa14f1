"""One rank of tests/test_torch_mesh_axes.py's runs over the mesh's dp and ep
axes.

Run as ``python torch_mesh_axes_worker.py RANK WORLD INIT_FILE INPUTS
OUTPUT``: it joins a gloo group of WORLD (4) ranks through the ``file://``
store INIT_FILE, reads the parameter trees (numpy, as
`metalchat_tpu_torch.convert.params_from_numpy` takes them), the configs and
the inputs from the pickle INPUTS, runs every case of `CASES` on the CPU and
pickles {case: result} to OUTPUT. The two-rank cases run on the pairs of
ranks {0, 1} and {2, 3} (`make_mesh(..., group=pair)`), each pair the same
program. It imports torch, numpy and the port only.
"""

import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import metalchat_tpu_torch.config as tconfig  # noqa: E402
from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache  # noqa: E402
from metalchat_tpu_torch.convert import params_from_numpy  # noqa: E402
from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402
from metalchat_tpu_torch.sampling import SamplerConfig  # noqa: E402
from metalchat_tpu_torch.parallel import (  # noqa: E402
    MultiHostEngine,
    MultiHostRoundError,
    MultiHostServer,
    initialize,
    make_hybrid_mesh,
    make_mesh,
    make_tp_decode_step,
    shard_cache,
    shard_params,
    shutdown,
)

CPU = torch.device("cpu")
# tests/test_tp_decode.py's test_tp_moe_decode inputs.
MOE_S = 256
MOE_TOKENS, MOE_GREEDY_STEPS = [[5], [9]], 6
MOE_POSITIONS = [3, 7]
# The meshes of case (a): (tp, dp, ep) over the 4 ranks, and the calls that raise.
MESH_SHAPES = [(None, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2), (None, 4, 1), (1, 1, 4)]
MESH_ERRORS = [dict(dp=3), dict(tp=3, dp=1, ep=1), dict(tp=2, ep=4)]
HYBRID_SHAPES = [dict(dcn_dp=2, tp=2), dict(), dict(dcn_dp=4)]
HYBRID_ERRORS = [dict(dcn_dp=3, tp=2)]
# The engine over an ep mesh and a tp MoE mesh.
ENGINE = dict(max_slots=2, max_seq_len=64, decode_burst=2, prefill_chunk=8)
ENGINE_REQUESTS = [([1, 2, 3, 4, 5], 5), ([7, 8, 9], 4)]
# tests/test_multihost.py's prompts and budgets.
SERVE_PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [2, 7, 1, 8, 2, 8, 1], [1, 2, 3]]
SERVE_NEW = 8
FAIL_PROMPTS = [[3, 1, 4], [1, 5, 9], [2, 6, 5, 3, 5]]
FAIL_NEW = 6
# The engine on the dp 2 x tp 2 mesh: {case: (tree, config, engine arguments,
# requests)}, tests/test_tp_decode.py's test_tp_engine_spmd_token_exact,
# ..._paged_token_exact and test_tp_engine_w4a8_quantized_kv, and
# tests/test_parallel_serving.py's test_engine_spmd_paged.
DP_REQUESTS = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 5)]
DP_ENGINE = dict(max_slots=4, max_seq_len=64, decode_burst=4, prefill_chunk=16)
DP_ENGINES = {
    "dense": ("dp_dense", "tp", DP_ENGINE, DP_REQUESTS),
    "paged": ("dp_paged", "tp", dict(DP_ENGINE, cache_mode="paged", page_size=32), DP_REQUESTS),
    "w4a8": ("dp_w4a8", "tp", dict(DP_ENGINE, quantized_kv=True), DP_REQUESTS),
    "tiny_paged": ("tiny", "tiny", dict(max_slots=4, max_seq_len=32, prefill_chunk=16,
                                        cache_mode="paged", page_size=8, decode_burst=2),
                   [([1, 2, 3, 4, 5], 5), ([6, 7, 8], 4)]),
}
# tests/test_multihost_engine.py's SETUP: (prompt, budget, sampler or None).
MH_ENGINE = dict(max_slots=2, quantized_kv=True, decode_burst=4, prefill_chunk=16, seed=3)
MH_REQUESTS = [([3, 1, 4, 1, 5] * 8, 10, None), ([2, 7, 1], 6, None),
               ([9] * 17, 8, (0.8, 12, 0.9)), ([5, 5], 5, None)]


def mh_requests():
    return [Request(prompt=p, max_new_tokens=n, sampler=SamplerConfig.greedy() if s is None
                    else SamplerConfig(temperature=s[0], top_k=s[1], top_p=s[2]))
            for p, n, s in MH_REQUESTS]


def _cfg(data, name):
    kind, fields = data["cfgs"][name]
    return getattr(tconfig, kind)(**fields)


def _tree(data, name):
    return params_from_numpy(data[name], CPU)


def _place(mesh):
    return {a: mesh.index(a) for a in ("dp", "ep", "tp")}


def _delta(mesh, before):
    return {k: v - before.get(k, 0) for k, v in mesh.counts.items() if v != before.get(k, 0)}


def case_meshes(data, meshes):
    """(a) make_mesh and make_hybrid_mesh: each mesh's shape and this rank's
    place, the messages of the calls that raise, and make_mesh's refusal of
    an axis that needs sub-groups on a group passed in."""
    out = {"make_mesh": [], "hybrid": [], "errors": [], "hybrid_errors": []}
    for tp, dp, ep in MESH_SHAPES:
        m = make_mesh(tp=tp, dp=dp, ep=ep)
        out["make_mesh"].append((m.shape, _place(m)))
    for kw in HYBRID_SHAPES:
        m = make_hybrid_mesh(**kw)
        out["hybrid"].append((m.shape, _place(m)))
    for kw in MESH_ERRORS:
        try:
            make_mesh(**kw)
            out["errors"].append(None)
        except ValueError as err:
            out["errors"].append(str(err))
    for kw in HYBRID_ERRORS:
        try:
            make_hybrid_mesh(**kw)
            out["hybrid_errors"].append(None)
        except ValueError as err:
            out["hybrid_errors"].append(str(err))
    try:  # an axis shorter than the grid on a group other than the default one
        make_mesh(tp=2, dp=2, group=dist.group.WORLD)
        out["group_error"] = None
    except ValueError as err:
        out["group_error"] = str(err)
    # The sub-groups' collectives: each axis sums the ranks along it.
    m = meshes["tp2ep2"]
    rank = torch.tensor([float(dist.get_rank())])
    out["sums"] = {axis: m.all_reduce(rank.clone(), axis=axis).item() for axis in ("tp", "ep")}
    out["dp_sum"] = meshes["hybrid"].all_reduce(rank.clone(), axis="dp").item()
    out["gathered"] = meshes["hybrid"].all_gather(rank.clone(), dim=0, axis="dp").tolist()
    return out


def case_tp_moe(data, meshes):
    """(c) test_tp_moe_decode on a pair of ranks (tp 2): the dense f32
    model's greedy steps from position 0 on a dense cache, then one W4A8
    step at per-row positions on an int8 cache."""
    cfg, mesh = _cfg(data, "moe"), meshes["tp2"]
    params = shard_params(_tree(data, "moe_dense"), cfg, mesh)
    step = make_tp_decode_step(params, cfg, mesh)
    cache = shard_cache(KVCache.create(cfg, 2, MOE_S, dtype=torch.float32, device=CPU), mesh)
    tok, pos = torch.tensor(MOE_TOKENS), torch.zeros(2, dtype=torch.int32)
    first, ids = None, []
    for _ in range(MOE_GREEDY_STEPS):
        logits, cache = step(params, cache, tok, pos)
        first = logits.numpy().copy() if first is None else first
        tok = logits[:, -1].argmax(-1)[:, None]
        ids.append(tok[:, 0].numpy().copy())
        pos = pos + 1
    qparams = shard_params(_tree(data, "moe_w4a8"), cfg, mesh)
    before = dict(mesh.counts)
    qlogits, _ = make_tp_decode_step(qparams, cfg, mesh)(
        qparams, shard_cache(QuantizedKVCache.create(cfg, 2, MOE_S, device=CPU), mesh),
        torch.tensor(MOE_TOKENS), torch.tensor(MOE_POSITIONS, dtype=torch.int32))
    return {"logits": first, "ids": np.stack(ids), "w4a8": qlogits.numpy().copy(),
            "collectives": _delta(mesh, before)}


def case_ep_forward(data, meshes):
    """(d) test_ep_sharded_forward_matches: the 6-token forward of the tiny
    MoE on the tp 2 × ep 2 mesh and on a pair's ep 2 mesh."""
    cfg = _cfg(data, "ep")
    whole = _tree(data, "ep")
    out = {}
    for name in ("tp2ep2", "ep2"):
        mesh = meshes[name]
        cache = shard_cache(KVCache.create(cfg, 2, 16, dtype=torch.float32, device=CPU), mesh)
        before = dict(mesh.counts)
        logits, _ = forward(shard_params(whole, cfg, mesh), cache, torch.tensor(data["ep_tokens"]),
                            0, cfg, tp=mesh)
        out[name] = {"logits": logits.numpy().copy(), "collectives": _delta(mesh, before)}
    return out


def case_engines(data, meshes):
    """The engine on a pair's ep 2 mesh (the sharded layer route) and on its
    tp 2 mesh (MoE on the tensor-parallel decode), dense f32."""
    cfg = _cfg(data, "ep")
    out = {}
    for name in ("ep2", "tp2"):
        mesh = meshes[name]
        engine = ContinuousBatchingEngine(shard_params(_tree(data, "ep"), cfg, mesh), cfg,
                                          spmd_mesh=mesh, **ENGINE)
        done = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in ENGINE_REQUESTS])
        out[name] = {"tokens": [c.tokens for c in done.values()],
                     "finished": [c.finished and c.error is None for c in done.values()],
                     "route": engine.forward_fn.__qualname__.split(".")[0]}
    return out


def case_server(data, meshes):
    """(e) MultiHostServer on make_hybrid_mesh(dcn_dp=2, tp=2):
    tests/test_multihost.py's prompts, rank 0's requests only."""
    mesh = meshes["hybrid"]
    server = MultiHostServer(params=_tree(data, "llama"), config=_cfg(data, "llama"),
                             mesh=mesh, batch_size=2, max_new_tokens=SERVE_NEW)
    before = dict(mesh.counts)
    out = server.serve(SERVE_PROMPTS if mesh.rank == 0 else None)
    return {"results": out, "collectives": _delta(mesh, before)}


def case_round_failure(data, meshes):
    """(f) test_round_failure_containment: the second round fails on every
    rank; then the pending requests on the healthy server."""
    server = MultiHostServer(params=_tree(data, "llama"), config=_cfg(data, "llama"),
                             mesh=meshes["hybrid"], batch_size=2, max_new_tokens=FAIL_NEW)
    healthy, calls = server._round, {"n": 0}

    def flaky(toks, length):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated peer loss")
        return healthy(toks, length)

    server._round = flaky
    out = {}
    try:
        server.serve(FAIL_PROMPTS)
        out["raised"] = False
    except MultiHostRoundError as err:
        out.update(raised=True, round_index=err.round_index, pending=err.pending_indices,
                   completed=err.completed)
        server._round = healthy
        out["redo"] = server.serve([FAIL_PROMPTS[i] for i in err.pending_indices])
    return out


def _served(engine, done, mesh, before):
    return {"tokens": [c.tokens for c in done.values()],
            "finished": [c.finished and c.error is None for c in done.values()],
            "route": engine.forward_fn.__qualname__.split(".")[0],
            "local_slots": int(engine.cache.page_table.shape[0] if engine.paged
                               else engine.cache.k.shape[1]),
            "collectives": _delta(mesh, before)}


def case_dp_engines(data, meshes):
    """The engine on make_mesh(tp=2, dp=2) for each of DP_ENGINES, and the
    W4A8 one on a pair's tp 2 mesh (dp 1)."""
    out = {}
    for name, (tree, cfg_name, kw, requests) in DP_ENGINES.items():
        cfg = _cfg(data, cfg_name)
        runs = [("dp2tp2", name)] + ([("tp2", "w4a8_tp2")] if name == "w4a8" else [])
        for mesh_name, key in runs:
            mesh = meshes[mesh_name]
            engine = ContinuousBatchingEngine(shard_params(_tree(data, tree), cfg, mesh), cfg,
                                              spmd_mesh=mesh, **kw)
            before = dict(mesh.counts)
            done = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in requests])
            out[key] = _served(engine, done, mesh, before)
    return out


def case_multihost_engine(data, meshes):
    """tests/test_multihost_engine.py's run: MultiHostEngine on
    make_hybrid_mesh(dcn_dp=2, tp=2), rank 0's requests only."""
    mesh = meshes["hybrid"]
    engine = MultiHostEngine(_tree(data, "mh"), _cfg(data, "mh"), mesh, **MH_ENGINE)
    before = dict(mesh.counts)
    done = engine.run(mh_requests() if mesh.rank == 0 else None)
    return _served(engine.engine, done, mesh, before)


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


def main(argv) -> int:
    rank, world, init_file, inputs, output = (int(argv[1]), int(argv[2]), argv[3], argv[4],
                                              argv[5])
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
               timeout_s=90)
    try:
        with open(inputs, "rb") as f:
            data = pickle.load(f)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = pairs[rank // 2]
        meshes = {"tp2": make_mesh(tp=2, group=pair), "ep2": make_mesh(tp=1, ep=2, group=pair),
                  "tp2ep2": make_mesh(tp=2, ep=2), "hybrid": make_hybrid_mesh(dcn_dp=2, tp=2),
                  "dp2tp2": make_mesh(tp=2, dp=2)}
        with torch.no_grad():
            results = {name: fn(data, meshes) for name, fn in CASES.items()}
        results["places"] = {n: (m.shape, _place(m), m.rank) for n, m in meshes.items()}
        with open(output, "wb") as f:
            pickle.dump(results, f)
    finally:
        shutdown()
    print(f"OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
