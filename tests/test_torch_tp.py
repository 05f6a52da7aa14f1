"""The port's tensor parallelism (metalchat_tpu_torch/parallel/) against the
JAX package's (metalchat_tpu/parallel/), at tests/test_tp_decode.py's shapes
(`CFG`, tp = 2).

The JAX side runs first, on the 8-device virtual CPU mesh, its Pallas
kernels in interpret mode (``METALCHAT_TPU_PALLAS_INTERPRET=1``, as
tests/test_tp_decode.py runs them), and hands its parameters across as
numpy. The port's two ranks are two processes (tests/torch_tp_worker.py,
which imports torch, numpy and the port only) joined by gloo through a
``file://`` store under ``tmp_path``; one launch runs every case, and the
launch enforces its own time limit (`RANK_TIMEOUT_S`: pytest-timeout is not
installed). The port's single-device references run here.

Tolerances:

* shards (a): every local leaf byte for byte the JAX ``shard_params``
  shard on device r after ``_localize_quant_metadata``;
* dense f32 step (b): logits within 2e-4 of JAX's ``make_tp_decode_step``
  (tests/test_tp_decode.py's), 8 greedy ids equal;
* W4A8 steps, int8 cache (c) and pages (e): as the port's single-device
  parity tests hold ``decode_step`` (tests/test_torch_ffn_block.py): cache
  codes equal on every layer (layer 0 first, as JAX's tests hold it
  against one device), cache scales within 1e-6 relative, logits within
  1e-5;
* the tensor-parallel prefill (d) against the port's single-device
  ``forward``: W4A8 cache codes, scales and logits bit for bit, dense f32
  within 2e-4 (tests/test_tp_decode.py's GSPMD check);
* the engine (f): token-exact against the single-device engine, dense f32,
  dense and paged caches; ``MultiHostEngine`` (g): the same streams on both
  ranks;
* the sharded layer route on every leaf kind (i): a dense fused tree,
  group-wise int4 and int8 in both orientations, fused and not, GPT-2 with
  non-zero biases and an odd vocabulary, fused and not, and a LoRA tree: a
  40-token prompt's f32 logits, then one token's, within rtol/atol 2e-5
  (tests/test_parallel.py's tolerance) of JAX's ``forward(fast_decode=
  False)`` on one device and on its tp-2 CPU mesh; the engine on the trees
  the fast decode refuses token-exact to the port's single-device engine.
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

from metalchat_tpu import config as jconfig
from metalchat_tpu.config import config_from_dict as jconfig_from_dict
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import PagedKVCache as JPagedKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.models import fuse as jfusemod
from metalchat_tpu.models import forward as jforward
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.models.transformer import make_rope_tables as jrope_tables
from metalchat_tpu.models.fuse import fuse_projections as jfuse
from metalchat_tpu.parallel import mesh as jmesh
from metalchat_tpu.parallel import tp_decode as jtp
from metalchat_tpu.train.lora import attach_lora as jattach_lora
from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine, Request
from metalchat_tpu_torch.models import fuse as tfuse
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    make_tp_decode_step,
    shard_params,
    supports_tp_fast_decode,
    tp_refusal,
)
from metalchat_tpu_torch.parallel.distributed import initialize
from metalchat_tpu_torch.quant import quantize as tq
from torch_port_util import jax_tree_to_numpy, port_config

import torch_tp_worker as worker

jq = importlib.import_module("metalchat_tpu.quant.quantize")

HERE = Path(__file__).resolve().parent
CFG = JLlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                   max_seq_len=256, tie_word_embeddings=False)
TP = 2
PROMPT_LEN = 40  # over 16 tokens: the prefill's flash route
RANK_TIMEOUT_S = 150
CPU = torch.device("cpu")
LEAF_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_parallel.py's
# A small GPT-2: heads and FFN width that tp 2 divides, a vocabulary it does
# not (GPT-2's own 50257 is odd), so the embedding and tied head stay whole.
GPT2_HF = {"model_type": "gpt2", "n_embd": 128, "n_head": 4, "n_layer": 2, "n_positions": 64,
           "n_inner": None, "vocab_size": 509, "layer_norm_epsilon": 1e-5,
           "bos_token_id": 508, "eos_token_id": 508}
GPT2_CFG = jconfig_from_dict(GPT2_HF)
LEAF_NAMES = ("dense_fused", "int4", "int4_fused_t", "int8_n", "int8_fused", "gpt2",
              "gpt2_fused", "lora")


def _jmesh():
    return jmesh.make_mesh(tp=TP, dp=1, devices=jax.devices()[:TP])


def _w4a8(seed):
    return jq.quantize_params(jinit(CFG, seed=seed, dtype=jnp.float32), bits=4,
                              group_size=None, act_bits=8, scales_dtype=jnp.float32)


def _trees():
    return {"dense": jinit(CFG, seed=0, dtype=jnp.float32), "w4a8": _w4a8(1),
            "fused": jfuse(_w4a8(4), CFG)}


def _oriented(tree, transposed: bool):
    """Every quantized layer leaf stored ``transposed`` (or not)."""
    layers = {k: jq.with_orientation(v, transposed) if isinstance(v, jq.QuantizedTensor) else v
              for k, v in tree["layers"].items()}
    return dict(tree, layers=layers)


def _grouped(bits, seed):
    return jq.quantize_params(jinit(CFG, seed=seed, dtype=jnp.float32), bits=bits,
                              group_size=32)


def _gpt2_tree(seed=0):
    """GPT-2 f32 parameters from a numpy seed: non-zero norm and projection
    biases and positions, the head tied."""
    rng = np.random.default_rng(seed)
    h, f, L, V, S = 128, 512, 2, GPT2_CFG.vocab_size, GPT2_CFG.max_seq_len

    def w(*shape, fan):
        return jnp.asarray(rng.standard_normal(shape) * fan ** -0.5, jnp.float32)

    def small(*shape, scale=0.1):
        return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)

    embed = small(V, h, scale=0.3)
    layers = {"attn_norm": 1 + small(L, h), "attn_norm_b": small(L, h),
              "ffn_norm": 1 + small(L, h), "ffn_norm_b": small(L, h),
              "wq": w(L, h, h, fan=h), "wk": w(L, h, h, fan=h), "wv": w(L, h, h, fan=h),
              "wq_b": small(L, h), "wk_b": small(L, h), "wv_b": small(L, h),
              "wo": w(L, h, h, fan=h), "wo_b": small(L, h),
              "w1": w(L, h, f, fan=h), "w1_b": small(L, f), "w2": w(L, f, h, fan=f),
              "w2_b": small(L, h)}
    return {"embed": embed, "pos_emb": small(S, h, scale=0.3), "layers": layers,
            "final_norm": 1 + small(h), "final_norm_b": small(h), "lm_head": embed.T,
            "rope": jrope_tables(GPT2_CFG, S)}


def _lora_tree():
    """QLoRA's form: int8 group-32 bases with adaptors on every projection
    (``train.lora``), ``b`` made non-zero so that the adaptors count."""
    tree = jattach_lora(_grouped(8, 13), rank=4, seed=1)
    rng = np.random.default_rng(5)
    layers = {k: dataclasses.replace(v, b=jnp.asarray(
        rng.standard_normal(v.b.shape) * 0.02, jnp.float32))
        if isinstance(v, jq.LoraLinear) else v for k, v in tree["layers"].items()}
    return dict(tree, layers=layers)


def _leaf_trees():
    """The layer route's trees: {name: (JAX config, JAX tree)}."""
    gpt2 = _gpt2_tree()
    return {"dense_fused": (CFG, jfuse(jinit(CFG, seed=8, dtype=jnp.float32), CFG)),
            "int4": (CFG, _grouped(4, 9)),
            "int4_fused_t": (CFG, jfuse(_oriented(_grouped(4, 10), True), CFG)),
            "int8_n": (CFG, _oriented(_grouped(8, 11), False)),
            "int8_fused": (CFG, jfuse(_grouped(8, 12), CFG)),
            "gpt2": (GPT2_CFG, gpt2), "gpt2_fused": (GPT2_CFG, jfuse(gpt2, GPT2_CFG)),
            "lora": (CFG, _lora_tree())}


def _leaf_prompt(jcfg):
    return np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, PROMPT_LEN))


def _jax_leaf_results(leaves):
    """JAX's ``forward(fast_decode=False)`` on each leaf tree, on one device
    and on the tp-2 mesh (GSPMD on ``shard_params``' placement): the
    prompt's logits, then `worker.STEP_TOKEN`'s."""
    mesh = _jmesh()
    fwd = jax.jit(jforward, static_argnames=("config", "fast_decode"))
    out = {}
    for name, (jcfg, tree) in leaves.items():
        prompt = jnp.asarray(_leaf_prompt(jcfg), jnp.int32)
        res = {}
        for where, params, place in (("single", tree, lambda c: c),
                                     ("mesh", jmesh.shard_params(tree, jcfg, mesh),
                                      lambda c: jmesh.shard_cache(c, mesh))):
            cache = place(JKVCache.create(jcfg, 1, jcfg.max_seq_len, dtype=jnp.float32))
            prefill, cache = fwd(params, cache, prompt, 0, config=jcfg, fast_decode=False)
            step, _ = fwd(params, cache, jnp.asarray(worker.STEP_TOKEN, jnp.int32), PROMPT_LEN,
                          config=jcfg, fast_decode=False)
            res[where] = {"prefill": np.asarray(prefill), "step": np.asarray(step)}
        out[name] = res
    return out


def _jax_cache(cache):
    return {f.name: np.asarray(getattr(cache, f.name)) for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None}


def _jax_results(trees):
    """The JAX package's tensor-parallel steps on the 2-device mesh."""
    mesh = _jmesh()
    out = {}
    sdense = jmesh.shard_params(trees["dense"], CFG, mesh)
    step = jax.jit(jtp.make_tp_decode_step(sdense, CFG, mesh, cache_quantized=False))
    cache = jmesh.shard_cache(JKVCache.create(CFG, 2, CFG.max_seq_len, dtype=jnp.float32),
                              mesh)
    tok, pos, ids, first = jnp.asarray(worker.TOKENS, jnp.int32), jnp.zeros(2, jnp.int32), [], None
    for _ in range(worker.GREEDY_STEPS):
        logits, cache = step(sdense, cache, tok, pos)
        first = np.asarray(logits) if first is None else first
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        ids.append(np.asarray(tok)[:, 0])
        pos = pos + 1
    out["dense_greedy"] = {"logits": first, "ids": np.stack(ids)}
    tok, pos = jnp.asarray(worker.TOKENS, jnp.int32), jnp.asarray(worker.POSITIONS, jnp.int32)
    for name in ("w4a8", "fused"):
        sq = jmesh.shard_params(trees[name], CFG, mesh)
        logits, cache = jax.jit(jtp.make_tp_decode_step(sq, CFG, mesh))(
            sq, jmesh.shard_cache(JQKVCache.create(CFG, 2, CFG.max_seq_len), mesh), tok, pos)
        out[f"{name}_step"] = {"logits": np.asarray(logits), "cache": _jax_cache(cache)}
    sq = jmesh.shard_params(trees["w4a8"], CFG, mesh)
    pcache = JPagedKVCache.create(CFG, num_pages=worker.PAGED["num_pages"],
                                  page_size=worker.PAGED["page_size"],
                                  max_slots=worker.PAGED["max_slots"])
    pt = jnp.asarray(worker.PAGE_TABLE, jnp.int32)
    pcache = jmesh.shard_cache(pcache.replace(page_table=pt), mesh)
    pcache = pcache.replace(page_table=jax.device_put(pt))
    logits, pcache = jax.jit(jtp.make_tp_decode_step(sq, CFG, mesh, paged=True))(
        sq, pcache, tok, pos)
    out["paged_step"] = {"logits": np.asarray(logits), "cache": _jax_cache(pcache)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's per-rank results, numpy trees, port config)."""
    from metalchat_tpu import ops as jops

    trees, leaves = _trees(), _leaf_trees()
    numpy_trees = {k: jax_tree_to_numpy(v) for k, v in trees.items()}
    numpy_leaves = {k: jax_tree_to_numpy(t) for k, (_, t) in leaves.items()}
    prompt = np.random.default_rng(3).integers(0, CFG.vocab_size, (1, PROMPT_LEN))
    tmp = tmp_path_factory.mktemp("tp")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"cfg": {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)},
                     "prompt": prompt.tolist(), **numpy_trees,
                     "leaves": {k: {"cfg": _cfg_entry(c), "tree": numpy_leaves[k],
                                    "prompt": _leaf_prompt(c).tolist()}
                                for k, (c, _) in leaves.items()}}, f)
    # MKL's dynamic threading may give a loaded rank fewer threads, which
    # splits the attention's batched products another way and moves f32
    # sums by an ulp (enough to move an act8 code): each rank keeps its two.
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_DYNAMIC="FALSE", OMP_DYNAMIC="FALSE")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_tp_worker.py"), str(r), str(TP),
         str(tmp / "store"), str(tmp / "inputs.pkl"), str(tmp / f"rank{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(TP)]
    logs = []
    try:  # the JAX side while the ranks run
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("METALCHAT_TPU_PALLAS_INTERPRET", "1")
            jops.use_pallas.cache_clear()
            try:
                want = _jax_results(trees)
            finally:
                jops.use_pallas.cache_clear()
        want["leaves"] = _jax_leaf_results(leaves)
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:  # a rank that hangs is killed, and the launch fails
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK {r}" in log, f"rank {r} failed:\n{log}"
    ranks = []
    for r in range(TP):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks, dict(numpy_trees, leaves=numpy_leaves), port_config(CFG), prompt


def _cfg_entry(jcfg):
    cfg = port_config(jcfg)
    return type(cfg).__name__, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _whole_cache(ranks, case):
    """The ranks' local caches joined along the kv-head axis."""
    axes = {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2, "k_pages": 1, "v_pages": 1}
    parts = [r[case]["cache"] for r in ranks]
    return {n: (np.concatenate([p[n] for p in parts], axis=axes[n]) if n in axes
                else parts[0][n]) for n in parts[0]}


# -- (a) shard_params: the JAX shards byte for byte ---------------------------

def _jax_shard(arr, device):
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


@pytest.mark.parametrize("name", ["dense", "w4a8", "fused"])
def test_shard_params_equals_jax_shards(name):
    """Every rank's local leaf equals the JAX ``shard_params`` shard on device
    r after ``_localize_quant_metadata``: the int4 repack of wo/w2 per
    chunk, the fused permutation of wqkv/w13, the vocabulary shards."""
    tree = _trees()[name]
    mesh = _jmesh()
    sharded = jmesh.shard_params(tree, CFG, mesh)
    full = params_from_numpy(jax_tree_to_numpy(tree), CPU)
    cfg = port_config(CFG)
    for r in range(TP):
        local = shard_params(full, cfg, Mesh(tp=TP, rank=r))
        dev = mesh.devices[0, r]

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


# -- (b), (c), (e): the tensor-parallel step against JAX's ----------------------

def test_dense_tp_step_matches_jax(runs):
    """Dense f32: logits within 2e-4 of JAX's tensor-parallel step, 8
    greedy steps token for token, both ranks the same logits."""
    want, ranks, *_ = runs
    got = ranks[0]["dense_greedy"]
    np.testing.assert_allclose(got["logits"], want["dense_greedy"]["logits"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(got["ids"], want["dense_greedy"]["ids"])
    np.testing.assert_array_equal(ranks[1]["dense_greedy"]["logits"], got["logits"])


def _check_step(want, ranks, case, layer0_only=()):
    whole = _whole_cache(ranks, case)
    for n, w in want[case]["cache"].items():
        if n in ("page_table", "lengths"):
            continue
        g = whole[n]
        if n.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{case} {n}")
        else:  # codes: layer 0, then every layer, bit for bit
            np.testing.assert_array_equal(g[0], w[0], f"{case} {n} layer 0")
            np.testing.assert_array_equal(g, w, f"{case} {n}")
    np.testing.assert_allclose(ranks[0][case]["logits"], want[case]["logits"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ranks[1][case]["logits"], ranks[0][case]["logits"])
    # one all_reduce for the embedding, one after wo and one after w2 a
    # layer; one all_gather for the logits
    assert ranks[0][case]["collectives"] == {"all_reduce_sum": 1 + 2 * CFG.num_layers,
                                             "all_gather": 1}


@pytest.mark.parametrize("case", ["w4a8_step", "fused_step"])
def test_w4a8_tp_step_matches_jax(runs, case):
    """W4A8 with an int8 cache, unfused and fused (wqkv/w13 block-permuted):
    the port's tensor-parallel step against JAX's."""
    want, ranks, *_ = runs
    _check_step(want, ranks, case)


def test_paged_tp_step_matches_jax(runs):
    """Paged, pools split by kv-head, page table whole: the port's
    tensor-parallel step against JAX's (tests/test_tp_decode.py's
    test_tp_paged_kernel_path setting)."""
    want, ranks, *_ = runs
    _check_step(want, ranks, "paged_step")


# -- (d): the tensor-parallel prefill computes the single device's function -----

@pytest.mark.parametrize("name", ["w4a8", "fused", "dense"])
def test_tp_prefill_matches_single_device(runs, name):
    """``forward(..., tp=mesh)`` over a 40-token prompt against the port's
    single-device ``forward``: W4A8 codes, scales and logits bit for bit
    (act8 scales from the whole row, exact int32 sums), dense f32 within
    2e-4."""
    _, ranks, trees, cfg, prompt = runs
    params = params_from_numpy(trees[name], CPU)
    if name == "dense":
        cache = KVCache.create(cfg, 1, cfg.max_seq_len, dtype=torch.float32, device=CPU)
    else:
        cache = QuantizedKVCache.create(cfg, 1, cfg.max_seq_len, device=CPU)
    with torch.no_grad():
        logits, cache = forward(params, cache, torch.from_numpy(prompt), 0, cfg)
    case = f"prefill_{name}"
    whole = _whole_cache(ranks, case)
    got = ranks[0][case]["logits"]
    np.testing.assert_array_equal(ranks[1][case]["logits"], got)
    if name == "dense":
        np.testing.assert_allclose(got, logits.numpy(), rtol=2e-4, atol=2e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(whole[n], getattr(cache, n).numpy(), rtol=2e-4,
                                       atol=2e-4)
        return
    np.testing.assert_array_equal(got, logits.numpy())
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(whole[n], getattr(cache, n).numpy(), n)


# -- (f), (g): the engine ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_spmd_token_exact(runs, mode):
    """``ContinuousBatchingEngine(spmd_mesh=...)`` on two ranks, dense f32:
    the single-device engine's tokens (tests/test_tp_decode.py's
    test_tp_engine_spmd_token_exact and ..._paged_token_exact), every
    request finished, the forward the tensor-parallel one."""
    _, ranks, trees, cfg, _ = runs
    engine = ContinuousBatchingEngine(params_from_numpy(trees["dense"], CPU), cfg,
                                      **worker.ENGINE, **worker.ENGINE_MODES[mode])
    out = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in worker.REQUESTS])
    want = [c.tokens for c in out.values()]
    for r in ranks:
        got = r[f"engine_{mode}"]
        assert all(got["finished"]) and got["collectives"] is True
        assert got["tokens"] == want, (got["tokens"], want)


def test_multihost_engine_same_streams(runs):
    """``MultiHostEngine``: rank 1 passes None, rank 0's requests (two
    greedy, one sampled with a seeded sampler) are served on both ranks, and
    both return the same streams."""
    _, ranks, *_ = runs
    streams = [r["multihost"] for r in ranks]
    assert all(streams[0]["finished"]) and len(streams[0]["tokens"]) == 3
    assert [len(t) for t in streams[0]["tokens"]] == [n for _, n in worker.REQUESTS] + [7]
    assert streams[1] == streams[0]


# -- (h): gating -------------------------------------------------------------------

def test_gating_refuses_what_jax_refuses():
    """``supports_tp_fast_decode`` on tests/test_tp_decode.py's cases (a
    dense model; a dense fused leaf; kv-heads that tp=4 does not divide)
    and a grouped weight-only model: the JAX package's answers. kv-heads
    that tp does not divide, refused by the fast decode as by JAX's gate,
    take the sharded layer route (`spmd_forward_fn`), whose kv-heads stay
    whole, as JAX's GSPMD replicates them. MoE as
    JAX answers it: stacked experts on a tp-only mesh are taken, a mesh
    with ep > 1 is refused with the reason (and so is a tree without its
    router). A LoRA leaf on an act8 base: JAX's gate takes it and its step
    raises (whole adaptors added to local shapes); the port's gate refuses
    it, and the engine serves such a tree on the layer route."""
    cfg = port_config(CFG)
    params = jinit(CFG, seed=0, dtype=jnp.float32)
    tparams = params_from_numpy(jax_tree_to_numpy(params), CPU)
    grouped = jq.quantize_params(params, bits=4, group_size=32)
    cases = [
        (params, tparams, TP),
        (dict(params, layers=dict(params["layers"], wqkv=1)),
         dict(tparams, layers=dict(tparams["layers"], wqkv=torch.zeros(1))), TP),
        (params, tparams, 4),
        (grouped, params_from_numpy(jax_tree_to_numpy(grouped), CPU), TP),
    ]
    for jp, tp_, tp in cases:
        want = jtp.supports_tp_fast_decode(jp, CFG, jmesh.make_mesh(
            tp=tp, dp=1, devices=jax.devices()[:tp]))
        assert supports_tp_fast_decode(tp_, cfg, Mesh(tp=tp)) == want
    assert [supports_tp_fast_decode(c[1], cfg, Mesh(tp=c[2])) for c in cases] == [
        True, False, False, False]
    assert "not divisible" in tp_refusal(tparams, cfg, Mesh(tp=4))
    from metalchat_tpu_torch.parallel import layer_route_refusal, spmd_forward_fn

    assert layer_route_refusal(cfg, Mesh(tp=4)) is None
    assert spmd_forward_fn(tparams, cfg, Mesh(tp=4)).__qualname__.startswith(
        "layer_route_forward_fn")
    jmoe_cfg = jconfig.MixtralConfig(**{**{f.name: getattr(CFG, f.name)
                                           for f in dataclasses.fields(CFG)},
                                        "num_experts": 4, "num_experts_per_tok": 2})
    jmoe = jinit(jmoe_cfg, seed=0, dtype=jnp.float32)
    moe, tmoe = port_config(jmoe_cfg), params_from_numpy(jax_tree_to_numpy(jmoe), CPU)
    for tp, ep in ((TP, 1), (TP, 2)):
        want = jtp.supports_tp_fast_decode(jmoe, jmoe_cfg, jmesh.make_mesh(
            tp=tp, ep=ep, devices=jax.devices()[:tp * ep]))
        assert supports_tp_fast_decode(tmoe, moe, Mesh(tp=tp, ep=ep)) == want == (ep == 1)
    assert "ep=2" in tp_refusal(tmoe, moe, Mesh(tp=TP, ep=2))
    assert "MoE" in tp_refusal(tparams, moe, Mesh(tp=TP))  # no router in the tree
    # LoRA on an act8 base: JAX's gate takes it, then its step adds whole
    # adaptors to local shapes and raises; the port refuses it at the gate.
    jlora = jattach_lora(jq.quantize_params(params, bits=4, group_size=None, act_bits=8,
                                            scales_dtype=jnp.float32), rank=4, targets=("wq",))
    jm = _jmesh()
    assert jtp.supports_tp_fast_decode(jlora, CFG, jm)
    sq = jmesh.shard_params(jlora, CFG, jm)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(jtp.make_tp_decode_step(sq, CFG, jm))(
            sq, jmesh.shard_cache(JQKVCache.create(CFG, 2, CFG.max_seq_len), jm),
            jnp.asarray(worker.TOKENS, jnp.int32), jnp.asarray(worker.POSITIONS, jnp.int32))
    lora = params_from_numpy(jax_tree_to_numpy(jlora), CPU)
    assert "LoRA" in tp_refusal(lora, cfg, Mesh(tp=TP))
    with pytest.raises(ValueError, match="not divisible"):
        make_tp_decode_step(tparams, cfg, Mesh(tp=4))


def test_biased_model_raises(runs):
    """A model with biases: the tensor-parallel step refuses it with the
    reason, and ``decode_step(..., tp=)`` raises as JAX's does
    (``decode_step(..., tp_axis=)`` on ``use_bias``). The sharded layer
    route takes it: ``forward(..., tp=)`` on the small GPT-2 (non-zero
    biases, an odd vocabulary: the embedding and the tied head whole) is the
    port's single-device ``forward`` within 2e-5, the whole logits on every
    rank with no gather."""
    from metalchat_tpu_torch.models.decode import decode_step

    cfg = dataclasses.replace(port_config(CFG), use_bias=True)
    params = params_from_numpy(jax_tree_to_numpy(jinit(CFG, seed=0, dtype=jnp.float32)),
                               CPU)
    with pytest.raises(ValueError, match="use_bias"):
        make_tp_decode_step(params, cfg, Mesh(tp=TP))
    cache = KVCache.create(cfg, 1, 16, dtype=torch.float32, device=CPU)
    with pytest.raises(NotImplementedError, match="use_bias"):
        decode_step(params, cache, torch.tensor([[5]]), 0, cfg, tp=Mesh(tp=TP))
    _, ranks, trees, _, _ = runs
    gcfg = port_config(GPT2_CFG)
    gpt2 = params_from_numpy(trees["leaves"]["gpt2"], CPU)
    with torch.no_grad():
        cache = KVCache.create(gcfg, 1, gcfg.max_seq_len, dtype=torch.float32, device=CPU)
        want, cache = forward(gpt2, cache, torch.from_numpy(_leaf_prompt(GPT2_CFG)), 0, gcfg)
        step, _ = forward(gpt2, cache, torch.tensor(worker.STEP_TOKEN), PROMPT_LEN, gcfg)
    for r in ranks:
        got = r["leaves"]["gpt2"]
        np.testing.assert_allclose(got["prefill"], want.numpy(), **LEAF_TOL)
        np.testing.assert_allclose(got["step"], step.numpy(), **LEAF_TOL)
        assert "all_gather" not in got["collectives"]


# -- the layout pieces against the JAX package's ------------------------------------

@pytest.mark.parametrize("transposed", [True, False])
def test_repack_and_unpack_int4_match_jax(transposed):
    """``repack_int4_chunks`` (on the tensor's device) the JAX package's
    bytes; ``_unpack_int4(q, chunks)`` its nibbles; ``dequantize`` and
    ``linear`` of a chunk-packed leaf those of the standard one."""
    w = np.random.default_rng(0).standard_normal((2, 256, 96)).astype(np.float32)
    jleaf = jq.quantize(w, bits=4, group_size=None, act_bits=8, transposed=transposed)
    tleaf = tq.quantize(w, bits=4, group_size=None, act_bits=8, transposed=transposed,
                        device=CPU)
    jre, tre = jq.repack_int4_chunks(jleaf, 4), tq.repack_int4_chunks(tleaf, 4)
    assert tre.pack_chunks == jre.pack_chunks == 4
    np.testing.assert_array_equal(tre.q.numpy(), np.asarray(jre.q))
    packed = jre.q if not transposed else jnp.swapaxes(jre.q, -1, -2)
    tpacked = tre.q if not transposed else tre.q.transpose(-1, -2)
    np.testing.assert_array_equal(tq._unpack_int4(tpacked, 4).numpy(),
                                  np.asarray(jq._unpack_int4(packed, 4)))
    assert torch.equal(tq.dequantize(tre, torch.float32), tq.dequantize(tleaf, torch.float32))
    assert torch.equal(tq.standard_packing(tre).q, tleaf.q)
    x = torch.randn(3, 256)
    assert torch.equal(tq.linear(x, tre.layer(1)), tq.linear(x, tleaf.layer(1)))


def test_fused_blocking_matches_jax():
    """``permute_fused_tp`` the JAX package's bytes, ``split_fused(...,
    blocks=)`` its segments; a single device's ``forward`` on the blocked
    tree equals the plain tree's (as JAX's GSPMD check)."""
    jfused = jfuse(_w4a8(5), CFG)
    cfg = port_config(CFG)
    tfused = params_from_numpy(jax_tree_to_numpy(jfused), CPU)
    blocked = dict(tfused, layers=dict(tfused["layers"]))
    for name in ("wqkv", "w13"):
        segs = tfuse.fused_segments(name, cfg)
        jb = jfusemod.permute_fused_tp(jfused["layers"][name], segs, TP)
        tb = tfuse.permute_fused_tp(tfused["layers"][name], segs, TP)
        assert tb.fuse_tp == jb.fuse_tp == TP
        np.testing.assert_array_equal(tb.q.numpy(), np.asarray(jb.q))
        np.testing.assert_array_equal(tb.scales.numpy(), np.asarray(jb.scales))
        blocked["layers"][name] = tb
        y = np.arange(sum(segs) * 2, dtype=np.float32).reshape(2, -1)
        jparts = jfusemod.split_fused(jnp.asarray(y), segs, blocks=TP)
        for g, w in zip(tfuse.split_fused(torch.from_numpy(y), segs, blocks=TP), jparts):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    with torch.no_grad():
        want, _ = forward(tfused, QuantizedKVCache.create(cfg, 1, 64, device=CPU), tokens, 0,
                          cfg)
        got, _ = forward(blocked, QuantizedKVCache.create(cfg, 1, 64, device=CPU), tokens, 0,
                         cfg)
        want1, _ = forward(tfused, QuantizedKVCache.create(cfg, 1, 64, device=CPU),
                           tokens[:, :1], 0, cfg)
        got1, _ = forward(blocked, QuantizedKVCache.create(cfg, 1, 64, device=CPU),
                          tokens[:, :1], 0, cfg)
    assert torch.equal(got, want) and torch.equal(got1, want1)


def test_convert_keeps_tp_layout_fields():
    """A JAX leaf's ``pack_chunks`` and ``fuse_tp`` cross with its bytes."""
    sq = jmesh.shard_params(jfuse(_w4a8(6), CFG), CFG, _jmesh())
    tree = params_from_numpy(jax_tree_to_numpy(sq), CPU)
    assert tree["layers"]["wqkv"].fuse_tp == TP and tree["layers"]["w13"].fuse_tp == TP
    assert tree["layers"]["wo"].pack_chunks == TP and tree["layers"]["w2"].pack_chunks == TP
    np.testing.assert_array_equal(tree["layers"]["wo"].q.numpy(),
                                  np.asarray(sq["layers"]["wo"].q))


def test_single_process_mesh_and_initialize():
    """One process: ``initialize`` does nothing, ``make_mesh`` is one rank,
    and a larger tp without a process group raises."""
    assert initialize(world_size=1) is False
    assert make_mesh() == Mesh(tp=1, rank=0)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(tp=TP)
    with pytest.raises(ValueError, match="rank"):
        initialize("file:///nonexistent", world_size=2, device="cpu")
    params = {"layers": {}}
    assert shard_params(params, port_config(CFG), Mesh()) is params


def test_forward_fn_and_cache_options(runs):
    """``forward_fn`` on ``generate`` and the engine, and the engine's
    ``cache=``: the default path's tokens; a forward marked ``collectives``
    sends ``DecodeStep`` and the engine's bursts to the eager route on the
    card's device type too, and only such a forward does."""
    from metalchat_tpu_torch.engine.generate import DecodeStep, generate
    from metalchat_tpu_torch.sampling import SamplerConfig

    _, _, trees, cfg, prompt = runs
    params = params_from_numpy(trees["w4a8"], CPU)
    calls = []

    def fwd(p, c, t, s):
        calls.append(t.shape[1])
        return forward(p, c, t, s, cfg)

    tokens = torch.from_numpy(prompt[:, :12])
    with torch.no_grad():
        want = generate(params, cfg, tokens, max_new_tokens=5, quantized_kv=True)
        got = generate(params, cfg, tokens, max_new_tokens=5, quantized_kv=True,
                       forward_fn=fwd)
    assert torch.equal(got, want) and calls == [12, 1, 1, 1, 1]
    requests = [Request(prompt=p, max_new_tokens=n) for p, n in worker.REQUESTS]
    base = ContinuousBatchingEngine(params, cfg, quantized_kv=True, **worker.ENGINE)
    want = [c.tokens for c in base.run(requests).values()]
    cache = QuantizedKVCache.create(cfg, worker.ENGINE["max_slots"],
                                    worker.ENGINE["max_seq_len"], device=CPU)
    engine = ContinuousBatchingEngine(params, cfg, cache=cache, forward_fn=fwd,
                                      **worker.ENGINE)
    requests = [Request(prompt=p, max_new_tokens=n) for p, n in worker.REQUESTS]
    assert [c.tokens for c in engine.run(requests).values()] == want
    assert engine.cache is cache and bool(cache.k.any())
    with pytest.raises(ValueError, match="dense modes"):
        ContinuousBatchingEngine(params, cfg, cache=cache, cache_mode="paged", **worker.ENGINE)
    cuda = torch.device("cuda")
    fwd.collectives = True
    assert not DecodeStep(cfg, SamplerConfig.greedy(), forward_fn=fwd)._graph_route(cuda)
    assert DecodeStep(cfg, SamplerConfig.greedy())._graph_route(cuda)
    assert not engine._graph_route()  # the engine's device is the CPU
    engine.device = cuda
    assert not engine._graph_route()
    base.device = cuda
    assert base._graph_route()


def test_engine_spmd_refuses_an_ineligible_model(runs):
    """``spmd_mesh`` with a tree the tensor-parallel decode refuses (dense
    fused, group-wise int4, GPT-2's biases, LoRA): the engine takes the
    sharded layer route, as the JAX engine pins ``forward(fast_decode=
    False)`` for GSPMD, and its tokens are the single-device engine's.
    What that route cannot run is still refused with the reason: an FFN
    width that tp does not divide (`shard_params` refuses it, as JAX's
    ``_check_divisibility`` does). kv-heads that tp does not divide are no
    longer refused: the layer route keeps them whole
    (tests/test_torch_train_sharded.py holds it to JAX)."""
    _, ranks, trees, cfg, _ = runs
    leaves = _leaf_trees()
    for name in worker.LEAF_ENGINES:
        lcfg = port_config(leaves[name][0])
        engine = ContinuousBatchingEngine(params_from_numpy(trees["leaves"][name], CPU), lcfg,
                                          **worker.ENGINE)
        out = engine.run([Request(prompt=p, max_new_tokens=n) for p, n in worker.REQUESTS])
        want = [c.tokens for c in out.values()]
        for r in ranks:
            got = r["engine_leaves"][name]
            assert all(got["finished"]) and got["route"] == "layer_route_forward_fn", name
            assert got["tokens"] == want, (name, got["tokens"], want)
    grouped = params_from_numpy(trees["leaves"]["int4"], CPU)
    with pytest.raises(ValueError, match="intermediate_size=1023 not divisible by tp=2"):
        ContinuousBatchingEngine(grouped, dataclasses.replace(cfg, intermediate_size=1023),
                                 spmd_mesh=Mesh(tp=TP), **worker.ENGINE)


@pytest.mark.parametrize("name", LEAF_NAMES)
def test_layer_route_leaf_kinds_match_jax(runs, name):
    """``forward(..., tp=mesh)`` on two ranks against JAX's ``forward(
    fast_decode=False)`` on one device and on its tp-2 mesh, f32 within
    2e-5: the prompt's logits (flash), then one token's (row 6's plain
    version on the 256-position cache; GPT-2's 64 take the reference
    attention). Both ranks hold the same logits; one all_reduce for the
    embedding and one after each row-parallel product (and its adaptor) a
    layer, one all_gather where the lm_head is split."""
    want, ranks, *_ = runs
    jcfg = GPT2_CFG if name.startswith("gpt2") else CFG
    per_call = 1 + 2 * jcfg.num_layers * (2 if name == "lora" else 1)
    gathers = {} if jcfg.vocab_size % TP else {"all_gather": 2}
    for r in ranks:
        got = r["leaves"][name]
        for part in ("prefill", "step"):
            for where in ("single", "mesh"):
                np.testing.assert_allclose(got[part], want["leaves"][name][where][part],
                                           **LEAF_TOL, err_msg=f"{name} {part} vs JAX {where}")
            np.testing.assert_array_equal(got[part], ranks[0]["leaves"][name][part])
        assert got["collectives"] == {"all_reduce_sum": 2 * per_call, **gathers}, name


def test_shard_params_refuses_straddling_groups_and_segments():
    """The layouts the sharded layer route cannot run are refused with the
    reason: a row-parallel group-wise leaf whose rank would hold part of a
    group, and a fused leaf whose segments tp does not divide. A fused wqkv
    whose kv-heads tp does not divide (dense or quantized) is no longer
    refused: each rank holds its query heads' columns and every k and v
    column (its kv-heads whole, as JAX's GSPMD replicates them). A whole
    embedding (an odd vocabulary) looks ids up on rank 0 only: the
    all_reduce sums one row and zeros."""
    from metalchat_tpu_torch.models.transformer import _tp_lookup_embedding
    from metalchat_tpu_torch.parallel.mesh import _fused_columns

    cfg = port_config(CFG)
    w = np.random.default_rng(0).standard_normal((1, 512, 512)).astype(np.float32)
    wide = tq.quantize(w, bits=8, group_size=256, device=CPU)
    with pytest.raises(ValueError, match="straddle"):
        shard_params({"layers": {"wo": wide}}, cfg, Mesh(tp=4, rank=1))
    int4 = tq.quantize(w, bits=4, group_size=128, device=CPU)
    with pytest.raises(ValueError, match="int4 half-split"):
        shard_params({"layers": {"w2": int4}}, cfg, Mesh(tp=4, rank=0))
    assert shard_params({"layers": {"wo": int4}}, cfg, Mesh(tp=2, rank=1))["layers"][
        "wo"].group_size == 128
    with pytest.raises(ValueError, match="segments .* not divisible by tp=2"):
        _fused_columns("w13", dataclasses.replace(cfg, intermediate_size=7), TP, 0)
    odd = dataclasses.replace(cfg, num_kv_heads=1, head_dim=3)  # wqkv: 12 | 3 | 3
    dense = torch.randn(1, 512, 18)
    quant = tq.quantize(dense.numpy(), bits=8, group_size=32, device=CPU)
    for rank in range(TP):
        cols = [*range(6 * rank, 6 * rank + 6), *range(12, 18)]
        got = shard_params({"layers": {"wqkv": dense}}, odd, Mesh(tp=TP, rank=rank))
        assert torch.equal(got["layers"]["wqkv"], dense[..., cols])
        got = shard_params({"layers": {"wqkv": quant}}, odd, Mesh(tp=TP, rank=rank))
        leaf = got["layers"]["wqkv"]
        assert leaf.fuse_tp == 1 and torch.equal(leaf.q, quant.q[..., cols])
        assert torch.equal(leaf.scales, quant.scales[..., cols])

    class Sum:  # two ranks' all_reduce, each rank's contribution recorded
        def __init__(self, tp):
            self.tp, self.seen = tp, []

        def index(self, axis):
            return self.rank

        def all_reduce(self, t):
            self.seen.append(t.clone())
            return t

    table = torch.randn(97, 8)
    ids = torch.tensor([[0, 5, 96]])
    parts = []
    for rank in range(TP):
        m = Sum(TP)
        m.rank = rank
        parts.append(_tp_lookup_embedding(ids, table, m))
    assert torch.equal(parts[0], table[ids]) and not parts[1].any()
