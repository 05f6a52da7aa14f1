"""The port's mesh axes dp and ep (metalchat_tpu_torch/parallel/: `make_mesh`,
`make_hybrid_mesh`, MoE under tp and over ep, `MultiHostServer`) against the
JAX package's (metalchat_tpu/parallel/).

The JAX side runs here, on the 8-device virtual CPU mesh, the tensor-parallel
MoE step's Pallas kernels in interpret mode
(``METALCHAT_TPU_PALLAS_INTERPRET=1``, as tests/test_tp_decode.py runs them),
and hands its parameters across as numpy. The port's ranks are four
processes (tests/torch_mesh_axes_worker.py, which imports torch, numpy and
the port only) joined by gloo through a ``file://`` store under
``tmp_path``; one launch runs every case, the two-rank ones on the pairs
{0, 1} and {2, 3}, and the launch enforces its own time limit
(`RANK_TIMEOUT_S`: pytest-timeout is not installed).

Tolerances:

* (a) mesh shapes, every rank's place on each axis and the error messages
  equal to JAX's ``make_mesh`` / ``make_hybrid_mesh`` on four devices;
* (b) every rank's shard of a tiny MoE on tp 2 × ep 2 byte for byte the JAX
  ``shard_params`` shard on its device after ``_localize_quant_metadata``;
* (c) tests/test_tp_decode.py's test_tp_moe_decode: dense f32 first logits
  within rtol/atol 5e-4 of JAX's tensor-parallel step and 6 greedy ids
  equal; W4A8 experts within 1e-5 of JAX's ``make_tp_decode_step`` and
  relative L2 under 5e-2 against one device;
* (d) tests/test_moe.py's test_ep_sharded_forward_matches (JAX at tp 2 ×
  ep 4; the port at tp 2 × ep 2 and at ep 2): f32 logits within 2e-4 of
  JAX's sharded forward and of its single device;
* (e) tests/test_multihost.py's serving run on ``make_hybrid_mesh(dcn_dp=2,
  tp=2)``: rank 0's ids equal to JAX's single-process ``generate``;
* (f) test_round_failure_containment: the failed round, the pending
  indices, the completed ids (JAX's) and the recovery;
* (g) the engine on a dp 2 × tp 2 mesh (tests/test_tp_decode.py's dense,
  paged and W4A8 engine runs, tests/test_parallel_serving.py's paged one):
  tokens equal to JAX's single-device engine (W4A8, where JAX asserts only
  completion: equal to the port's dp 1 × tp 2 engine, since dp only splits
  rows), and ``MultiHostEngine`` on ``make_hybrid_mesh(dcn_dp=2, tp=2)``
  (tests/test_multihost_engine.py's run): the greedy requests equal to
  JAX's single-device engine, the sampled one to the port's one-process
  engine, every rank's streams the same.
"""

import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import MixtralConfig as JMixtralConfig
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from metalchat_tpu.engine.serving import Request as JRequest
from metalchat_tpu.models import forward as jforward
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.models.decode import decode_step as jdecode_step
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.parallel import distributed as jdist
from metalchat_tpu.parallel import mesh as jmesh
from metalchat_tpu.parallel import tp_decode as jtp
from metalchat_tpu_torch.cache import QuantizedKVCache
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.models.decode import decode_step
from metalchat_tpu_torch.parallel import Mesh, shard_params
from metalchat_tpu_torch.quant import quantize as tq
from torch_port_util import jax_tree_to_numpy, port_config

import torch_mesh_axes_worker as worker
from test_model import TINY_LLAMA
from test_moe import CFG as EP_CFG

jq = importlib.import_module("metalchat_tpu.quant.quantize")

HERE = Path(__file__).resolve().parent
WORLD = 4
RANK_TIMEOUT_S = 150
CPU = torch.device("cpu")
# tests/test_tp_decode.py's test_tp_moe_decode model.
MOE_CFG = JMixtralConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                         max_seq_len=256, tie_word_embeddings=False, num_experts=4,
                         num_experts_per_tok=2)
# tests/test_multihost.py's model.
LLAMA_CFG = JLlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=64,
                         tie_word_embeddings=False)
# tests/test_tp_decode.py's CFG, tests/test_parallel_serving.py's model and
# tests/test_multihost_engine.py's SETUP.
TP_CFG = JLlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=256,
                      tie_word_embeddings=False)
TINY_CFG = TINY_LLAMA.replace(max_seq_len=96)
MH_CFG = LLAMA_CFG.replace(max_seq_len=128)


def _trees():
    moe = jinit(MOE_CFG, seed=7, dtype=jnp.float32)
    return {"moe_dense": moe,
            "moe_w4a8": jq.quantize_params(moe, bits=4, group_size=None, act_bits=8,
                                           scales_dtype=jnp.float32),
            "ep": jinit(EP_CFG, seed=1, dtype=jnp.float32),
            "llama": jinit(LLAMA_CFG, dtype=jnp.float32, max_seq_len=64),
            "dp_dense": jinit(TP_CFG, seed=2, dtype=jnp.float32),
            "dp_paged": jinit(TP_CFG, seed=3, dtype=jnp.float32),
            "dp_w4a8": jfuse(jq.quantize_params(jinit(TP_CFG, seed=6, dtype=jnp.float32), bits=4,
                                                group_size=None, act_bits=8,
                                                scales_dtype=jnp.float32), TP_CFG),
            "tiny": jinit(TINY_CFG, seed=11, dtype=jnp.float32),
            "mh": jinit(MH_CFG, dtype=jnp.float32, max_seq_len=128)}


# The JAX trees and configs of the dp engines, by worker.DP_ENGINES' names.
JAX_CFGS = {"tp": TP_CFG, "tiny": TINY_CFG, "mh": MH_CFG}


def _jax_engines(trees):
    """JAX's single-device engine on the dense, paged and tiny-paged dp cases
    and on tests/test_multihost_engine.py's requests (its tokens by
    request)."""
    out = {}
    for name, (tree, cfg_name, kw, requests) in worker.DP_ENGINES.items():
        if name == "w4a8":  # JAX asserts only completion for it
            continue
        engine = JEngine(trees[tree], JAX_CFGS[cfg_name], **kw)
        done = engine.run([JRequest(prompt=p, max_new_tokens=n) for p, n in requests])
        out[name] = [c.tokens for c in done.values()]
    engine = JEngine(trees["mh"], MH_CFG, **worker.MH_ENGINE)
    from metalchat_tpu.sampling import SamplerConfig as JSampler

    done = engine.run([JRequest(prompt=p, max_new_tokens=n, sampler=JSampler.greedy()
                                if s is None else JSampler(temperature=s[0], top_k=s[1],
                                                           top_p=s[2]))
                       for p, n, s in worker.MH_REQUESTS])
    out["multihost"] = [c.tokens for c in done.values()]
    return out


def _ep_tokens():
    return np.random.default_rng(1).integers(0, 128, (2, 6))


def _devices(n):
    return jax.devices()[:n]


def _jax_tp_moe(trees):
    """test_tp_moe_decode's JAX runs: the tensor-parallel steps and the
    single device's W4A8 step."""
    mesh = jmesh.make_mesh(tp=2, dp=1, devices=_devices(2))
    params = trees["moe_dense"]
    sparams = jmesh.shard_params(params, MOE_CFG, mesh)
    step = jax.jit(jtp.make_tp_decode_step(sparams, MOE_CFG, mesh, cache_quantized=False))
    cache = jmesh.shard_cache(JKVCache.create(MOE_CFG, 2, worker.MOE_S, dtype=jnp.float32),
                              mesh)
    tok, pos = jnp.asarray(worker.MOE_TOKENS, jnp.int32), jnp.zeros(2, jnp.int32)
    first, ids = None, []
    for _ in range(worker.MOE_GREEDY_STEPS):
        logits, cache = step(sparams, cache, tok, pos)
        first = np.asarray(logits) if first is None else first
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ids.append(np.asarray(tok)[:, 0])
        pos = pos + 1
    qparams = trees["moe_w4a8"]
    sq = jmesh.shard_params(qparams, MOE_CFG, mesh)
    assert jtp.supports_tp_fast_decode(sq, MOE_CFG, mesh)
    tok = jnp.asarray(worker.MOE_TOKENS, jnp.int32)
    pos = jnp.asarray(worker.MOE_POSITIONS, jnp.int32)
    lt, _ = jax.jit(jtp.make_tp_decode_step(sq, MOE_CFG, mesh))(
        sq, jmesh.shard_cache(JQKVCache.create(MOE_CFG, 2, worker.MOE_S), mesh), tok, pos)
    lr, _ = jax.jit(lambda p, c, t, s: jdecode_step(p, c, t, s, MOE_CFG))(
        qparams, JQKVCache.create(MOE_CFG, 2, worker.MOE_S), tok, pos)
    return {"logits": first, "ids": np.stack(ids), "w4a8": np.asarray(lt),
            "w4a8_single": np.asarray(lr)}


def _jax_ep(trees):
    """test_ep_sharded_forward_matches's JAX runs: one device, tp 2 × ep 4."""
    tokens = jnp.asarray(_ep_tokens(), jnp.int32)
    fwd = jax.jit(jforward, static_argnames="config")
    params = trees["ep"]
    ref, _ = fwd(params, JKVCache.create(EP_CFG, 2, 16, dtype=jnp.float32), tokens, 0,
                 config=EP_CFG)
    mesh = jmesh.make_mesh(tp=2, dp=1, ep=4, devices=_devices(8))
    cache = jax.device_put(JKVCache.create(EP_CFG, 2, 16, dtype=jnp.float32),
                           jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    got, _ = fwd(jmesh.shard_params(params, EP_CFG, mesh), cache, tokens, 0, config=EP_CFG)
    return {"single": np.asarray(ref), "sharded": np.asarray(got)}


def _jax_generate(params, prompts, new):
    return [np.asarray(jgenerate(params, LLAMA_CFG, jnp.asarray([p], jnp.int32),
                                 max_new_tokens=new))[0].tolist() for p in prompts]


def _launch(tmp: Path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_axes_worker.py"), str(r), str(WORLD),
         str(tmp / "store"), str(tmp / "inputs.pkl"), str(tmp / f"rank{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]


def _collect(procs, tmp: Path, deadline: float):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:  # a rank that hangs is killed, and the launch fails
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK {r}" in log, f"rank {r} failed:\n{log}"
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _cfg_entry(jcfg):
    cfg = port_config(jcfg)
    return type(cfg).__name__, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's per-rank results, the numpy trees)."""
    from metalchat_tpu import ops as jops

    tmp = tmp_path_factory.mktemp("mesh_axes")
    trees = _trees()
    numpy_trees = {k: jax_tree_to_numpy(v) for k, v in trees.items()}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"cfgs": {"moe": _cfg_entry(MOE_CFG), "ep": _cfg_entry(EP_CFG),
                              "llama": _cfg_entry(LLAMA_CFG),
                              **{k: _cfg_entry(c) for k, c in JAX_CFGS.items()}},
                     "ep_tokens": _ep_tokens().tolist(), **numpy_trees}, f)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    procs = _launch(tmp)
    try:
        want = {"ep": _jax_ep(trees),
                "serve": _jax_generate(trees["llama"], worker.SERVE_PROMPTS,
                                       worker.SERVE_NEW),
                "fail": _jax_generate(trees["llama"], worker.FAIL_PROMPTS[:1],
                                      worker.FAIL_NEW),
                "engines": _jax_engines(trees)}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("METALCHAT_TPU_PALLAS_INTERPRET", "1")
            jops.use_pallas.cache_clear()
            try:
                want["tp_moe"] = _jax_tp_moe(trees)
            finally:
                jops.use_pallas.cache_clear()
    finally:
        ranks = _collect(procs, tmp, deadline)
    return want, ranks, numpy_trees


# -- (a) the meshes -------------------------------------------------------------

def _jax_place(mesh, device_id):
    """(shape, {axis: place}) of device ``device_id`` on a JAX mesh."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    where = [int(i[0]) for i in np.nonzero(ids == device_id)]
    place = dict(zip(mesh.axis_names, where))
    return dict(mesh.shape), {a: place.get(a, 0) for a in ("dp", "ep", "tp")}


def test_make_mesh_matches_jax(runs):
    """``make_mesh(tp, dp, ep)`` on four ranks: JAX's shape ("dp", "ep",
    "tp", ep left out at 1), rank r at device r's place on every axis, and
    JAX's error messages."""
    _, ranks, _ = runs
    devs = _devices(WORLD)
    for i, (tp, dp, ep) in enumerate(worker.MESH_SHAPES):
        jm = jmesh.make_mesh(tp=tp, dp=dp, ep=ep, devices=devs)
        for r, res in enumerate(ranks):
            assert res["meshes"]["make_mesh"][i] == _jax_place(jm, devs[r].id), (tp, dp, ep, r)
    for i, kw in enumerate(worker.MESH_ERRORS):
        with pytest.raises(ValueError) as err:
            jmesh.make_mesh(**kw, devices=devs)
        assert all(res["meshes"]["errors"][i] == str(err.value) for res in ranks), kw


def test_make_hybrid_mesh_matches_jax(runs, monkeypatch):
    """``make_hybrid_mesh`` on four ranks against JAX's on four devices of
    one process (its defaults: dcn_dp the processes, tp the local
    devices): shapes, places and the error message."""
    _, ranks, _ = runs
    devs = _devices(WORLD)
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    monkeypatch.setattr(jax, "device_count", lambda *a: len(devs))
    for i, kw in enumerate(worker.HYBRID_SHAPES):
        jm = jdist.make_hybrid_mesh(**kw)
        for r, res in enumerate(ranks):
            assert res["meshes"]["hybrid"][i] == _jax_place(jm, devs[r].id), (kw, r)
    for i, kw in enumerate(worker.HYBRID_ERRORS):
        with pytest.raises(ValueError) as err:
            jdist.make_hybrid_mesh(**kw)
        assert all(res["meshes"]["hybrid_errors"][i] == str(err.value) for res in ranks)


def test_mesh_axis_collectives(runs):
    """Each axis's collective runs over the ranks along it: on tp 2 × ep 2,
    tp joins {0, 1} and {2, 3}, ep {0, 2} and {1, 3}; the hybrid mesh's dp
    joins {0, 2} and {1, 3}; the pairs' two-rank meshes sit where
    ``group=`` puts them."""
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        m = res["meshes"]
        tp_line, ep_line = [r - r % 2, r - r % 2 + 1], [r % 2, r % 2 + 2]
        assert m["sums"] == {"tp": float(sum(tp_line)), "ep": float(sum(ep_line))}
        assert m["dp_sum"] == float(sum(ep_line)) and m["gathered"] == ep_line
        places = res["places"]
        assert places["tp2"] == ({"dp": 1, "tp": 2}, {"dp": 0, "ep": 0, "tp": r % 2}, r % 2)
        assert places["ep2"] == ({"dp": 1, "ep": 2, "tp": 1}, {"dp": 0, "ep": r % 2, "tp": 0},
                                 r % 2)
        assert places["hybrid"] == ({"dp": 2, "tp": 2}, {"dp": r // 2, "ep": 0, "tp": r % 2}, r)


def test_make_mesh_refuses_sub_groups_off_the_default_group(runs):
    """``make_mesh(..., group=g)`` with an axis shorter than ``g`` raises
    before it makes a process group: ``torch.distributed.new_group`` needs
    every rank of the default group, and only ``g``'s ranks call it. An axis
    as long as ``g`` takes ``g`` itself (the pairs' meshes above)."""
    _, ranks, _ = runs
    for res in ranks:
        msg = res["meshes"]["group_error"]
        assert msg is not None and "'dp'" in msg and "needs sub-groups" in msg, msg


# -- (b) the shards -----------------------------------------------------------------

def _jax_shard(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("name", ["moe_dense", "moe_w4a8"])
def test_shard_params_tp_ep_equals_jax_shards(name):
    """tp 2 × ep 2: every rank's local leaf equals the JAX ``shard_params``
    shard on its device after ``_localize_quant_metadata``: the experts
    over ep, their FFN width over tp (w2's int4 repacked per chunk), the
    router and the dense leaves whole over ep."""
    tree = _trees()[name]
    mesh = jmesh.make_mesh(tp=2, dp=1, ep=2, devices=_devices(WORLD))
    sharded = jmesh.shard_params(tree, MOE_CFG, mesh)
    full = params_from_numpy(jax_tree_to_numpy(tree), CPU)
    cfg = port_config(MOE_CFG)
    for r in range(WORLD):
        local = shard_params(full, cfg, Mesh(tp=2, ep=2, rank=r))
        dev = mesh.devices[0, r // 2, r % 2]

        def check(path, want, got):
            if isinstance(want, dict):
                assert set(want) == set(got), path
                for k in want:
                    check(f"{path}/{k}", want[k], got[k])
            elif isinstance(want, jq.QuantizedTensor):
                jlocal = jtp._localize_quant_metadata(dataclasses.replace(
                    want, q=jnp.asarray(_jax_shard(want.q, dev)),
                    scales=jnp.asarray(_jax_shard(want.scales, dev))))
                assert isinstance(got, tq.QuantizedTensor), path
                for f in ("bits", "group_size", "transposed", "act_bits", "pack_chunks",
                          "fuse_tp"):
                    assert getattr(got, f) == getattr(jlocal, f), (path, f)
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(jlocal.q), path)
                np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jlocal.scales),
                                              path)
            else:
                np.testing.assert_array_equal(got.numpy(), _jax_shard(want, dev), path)

        check(name, sharded, local)


def test_shard_params_ep_guards():
    """JAX's ``_check_ep`` messages: an ep axis needs experts, and E must
    divide by ep."""
    cfg = port_config(LLAMA_CFG)
    tree = params_from_numpy(jax_tree_to_numpy(_trees()["llama"]), CPU)
    with pytest.raises(ValueError, match="has no experts"):
        shard_params(tree, cfg, Mesh(ep=2))
    moe = port_config(EP_CFG)
    with pytest.raises(ValueError, match="num_experts=4 not divisible by ep=3"):
        shard_params({"layers": {}}, moe, Mesh(ep=3))


# -- (c) MoE on the tensor-parallel decode -------------------------------------------

def test_tp_moe_dense_matches_jax(runs):
    """Dense f32 on a pair's tp 2 mesh: the first step's logits within 5e-4
    of JAX's tensor-parallel step, 6 greedy ids equal, on both pairs and
    both ranks of each."""
    want, ranks, _ = runs
    for res in ranks:
        got = res["tp_moe"]
        np.testing.assert_allclose(got["logits"], want["tp_moe"]["logits"], rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_array_equal(got["ids"], want["tp_moe"]["ids"])


def test_tp_moe_w4a8_matches_jax(runs):
    """W4A8 experts (the indexed matvec entry at F/tp, w2 act-quant per
    shard): logits within 1e-5 of JAX's ``make_tp_decode_step``, relative
    L2 under 5e-2 against the port's single device and JAX's; one
    all_reduce for the embedding, one after wo and one after the experts
    a layer, one all_gather."""
    want, ranks, trees = runs
    cfg = port_config(MOE_CFG)
    params = params_from_numpy(trees["moe_w4a8"], CPU)
    with torch.no_grad():
        single, _ = decode_step(params, QuantizedKVCache.create(cfg, 2, worker.MOE_S, device=CPU),
                                torch.tensor(worker.MOE_TOKENS),
                                torch.tensor(worker.MOE_POSITIONS, dtype=torch.int32), cfg)
    single = single.numpy()
    np.testing.assert_allclose(single, want["tp_moe"]["w4a8_single"], rtol=1e-5, atol=1e-5)
    for res in ranks:
        got = res["tp_moe"]["w4a8"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want["tp_moe"]["w4a8"], rtol=1e-5, atol=1e-5)
        rel = np.linalg.norm(got - single) / np.linalg.norm(single)
        assert rel < 5e-2, rel
        assert res["tp_moe"]["collectives"] == {"all_reduce_sum": 1 + 2 * MOE_CFG.num_layers,
                                                "all_gather": 1}


# -- (d) MoE over ep on the layer route -----------------------------------------------

@pytest.mark.parametrize("mesh", ["tp2ep2", "ep2"])
def test_ep_forward_matches_jax(runs, mesh):
    """The 6-token forward of the tiny MoE with its experts over ep: f32
    logits within 2e-4 of JAX's tp 2 × ep 4 forward and of its single
    device; the partial expert sums joined by one all_reduce over ep a
    layer (and over tp: the embedding, wo and w2 a layer, the logits
    gathered)."""
    want, ranks, _ = runs
    L = EP_CFG.num_layers
    counts = {"all_reduce_sum_ep": L}
    if mesh == "tp2ep2":
        counts.update(all_reduce_sum=1 + 2 * L, all_gather=1)
    for res in ranks:
        got = res["ep_forward"][mesh]
        np.testing.assert_allclose(got["logits"], want["ep"]["sharded"], atol=2e-4)
        np.testing.assert_allclose(got["logits"], want["ep"]["single"], atol=2e-4)
        assert got["collectives"] == counts


def test_engine_on_ep_and_tp_moe_meshes(runs):
    """``ContinuousBatchingEngine(spmd_mesh=...)`` with the tiny MoE, dense
    f32: on an ep 2 mesh the sharded layer route, on a tp 2 mesh the
    tensor-parallel decode; both the single-device engine's tokens."""
    _, ranks, trees = runs
    cfg = port_config(EP_CFG)
    engine = ContinuousBatchingEngine(params_from_numpy(trees["ep"], CPU), cfg, **worker.ENGINE)
    out = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in worker.ENGINE_REQUESTS])
    expected = [c.tokens for c in out.values()]
    routes = {"ep2": "layer_route_forward_fn", "tp2": "tp_decode_forward_fn"}
    for res in ranks:
        for name, route in routes.items():
            got = res["engines"][name]
            assert all(got["finished"]) and got["route"] == route
            assert got["tokens"] == expected, (name, got["tokens"], expected)


# -- (e), (f) MultiHostServer ------------------------------------------------------------

def test_multihost_server_matches_jax_generate(runs):
    """``MultiHostServer`` on ``make_hybrid_mesh(dcn_dp=2, tp=2)`` (batch 2,
    rounds by prompt length, the short round padded): rank 0's ids equal
    to JAX's single-process ``generate``, request by request; the other
    ranks return nothing; the ids gathered over dp once a round."""
    want, ranks, _ = runs
    assert ranks[0]["server"]["results"] == want["serve"]
    for res in ranks[1:]:
        assert res["server"]["results"] == []
    rounds = 2  # the 3-token prompt (its round padded), then the two 7-token ones
    for res in ranks:
        assert res["server"]["collectives"]["all_gather_dp"] == rounds
        assert res["server"]["collectives"]["broadcast_object"] == 1 + rounds


def test_multihost_round_failure_containment(runs):
    """A failed round keeps the finished ids (JAX's ``generate``'s) and
    names the requests to serve again (rank 0, which holds the queue); the
    healthy server serves them. Every rank raises at the same round."""
    want, ranks, _ = runs
    for r, res in enumerate(ranks):
        got = res["round_failure"]
        assert got["raised"] and got["round_index"] == 1
        if r == 0:
            assert got["pending"] == [2]
            assert got["completed"][0] == want["fail"][0]
            assert len(got["redo"]) == 1 and len(got["redo"][0]) == worker.FAIL_NEW
        else:
            assert got["pending"] == [] and got["completed"] == [] and got["redo"] == []


# -- (g) the engine over dp ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "paged", "tiny_paged"])
def test_dp_engine_token_exact(runs, case):
    """``ContinuousBatchingEngine(spmd_mesh=make_mesh(tp=2, dp=2))``, dense
    f32: the tokens of JAX's single-device engine on every rank. A dense
    cache holds max_slots / dp slots on each dp row, whose logits are
    gathered over dp once a model call; a paged one stays whole over dp
    (no dp collective). CFG's vocabulary takes the tensor-parallel decode,
    TINY_LLAMA's odd one the sharded layer route."""
    want, ranks, _ = runs
    kw = worker.DP_ENGINES[case][2]
    paged = kw.get("cache_mode") == "paged"
    for res in ranks:
        got = res["dp_engines"][case]
        assert all(got["finished"]) and got["tokens"] == want["engines"][case], (
            case, got["tokens"], want["engines"][case])
        assert got["route"] == ("layer_route_forward_fn" if case == "tiny_paged"
                                else "tp_decode_forward_fn")
        assert got["local_slots"] == kw["max_slots"] // (1 if paged else 2)
        assert ("all_gather_dp" in got["collectives"]) == (not paged), got["collectives"]


def test_dp_engine_w4a8_equals_dp1(runs):
    """tests/test_tp_decode.py's W4A8 engine (fused, int8 KV) on dp 2 × tp 2:
    every request completes with its length, as JAX asserts, and the
    tokens equal the port's engine on dp 1 × tp 2 (dp only splits the
    rows; the row-parallel act-quant is per shard in both)."""
    _, ranks, _ = runs
    lengths = [n for _, n in worker.DP_REQUESTS]
    for res in ranks:
        got, dp1 = res["dp_engines"]["w4a8"], res["dp_engines"]["w4a8_tp2"]
        assert all(got["finished"]) and [len(t) for t in got["tokens"]] == lengths
        assert got["tokens"] == dp1["tokens"], (got["tokens"], dp1["tokens"])


def test_multihost_engine_on_hybrid_mesh(runs):
    """``MultiHostEngine`` on ``make_hybrid_mesh(dcn_dp=2, tp=2)``: rank 0's
    four requests (mixed lengths, one past a prefill chunk, one sampled)
    on every rank; the greedy ones equal to JAX's single-device engine, the
    sampled one to the port's one-process engine (the same generator
    draws over the whole batch), and every rank's streams the same."""
    want, ranks, trees = runs
    cfg = port_config(MH_CFG)
    engine = ContinuousBatchingEngine(params_from_numpy(trees["mh"], CPU), cfg,
                                      **worker.MH_ENGINE)
    one = [c.tokens for c in engine.run(worker.mh_requests()).values()]
    got = ranks[0]["multihost_engine"]
    assert all(got["finished"])
    for i, (_, _, sampler) in enumerate(worker.MH_REQUESTS):
        if sampler is None:
            assert got["tokens"][i] == want["engines"]["multihost"][i], i
        assert got["tokens"][i] == one[i], i
    for res in ranks[1:]:
        assert res["multihost_engine"]["tokens"] == got["tokens"]
    assert got["local_slots"] == worker.MH_ENGINE["max_slots"] // 2
