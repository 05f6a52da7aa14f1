"""The port's pipeline and context parallelism (metalchat_tpu_torch/parallel/
pipeline.py, context.py, ring_attention.py, and what serves them) against
the JAX package's, at tests/test_pipeline.py's, tests/test_ring_attention.py's
and tests/test_parallel_serving.py's shapes.

The port's ranks are processes (tests/torch_pp_cp_worker.py, which imports
torch, numpy and the port only) joined by gloo through a ``file://`` store
under ``tmp_path``: one launch of 2 ranks and one of 4, each running every
case of its size; a launch enforces its own time limit (`RANK_TIMEOUT_S`).
They start first; the JAX side then runs on the 8-device virtual CPU mesh
in this process and hands its parameters across as numpy. A case's
single-process port run happens on rank 0, beside the parallel one.

Tolerances:

* pipeline prefill, f32 dense, (pp, dp, n_mb) in (2, 1, 1), (2, 1, 2),
  (2, 2, 2): logits within 2e-4 and the cache within 1e-5 of JAX's
  ``make_pipeline_forward`` (JAX's own tolerances), the logits equal on
  every rank, and at one microbatch bit for bit the port's one-process
  ``forward(fast_decode=False)``, the layer route that a stage runs
  (logits and every cache tensor);
* pipeline on an int8 cache (W4A8 tree, 2 microbatches), prefill and
  greedy steps at per-row offsets: cache codes equal, scales within 1e-6
  relative, logits within 1e-5 of JAX's, as tests/test_torch_tp.py case
  (c) holds the tensor-parallel step;
* ring attention, 2 and 4 ranks, causal and not: within 2e-5 of JAX's
  ``context_parallel_attention`` and of the dense reference
  (tests/test_ring_attention.py's);
* ``context_parallel_prefill``, f32 dense and int8 caches, 2 and 4 ranks:
  the logits and the written K/V (dense) within 2e-4 of JAX's
  (tests/test_parallel_serving.py's), the int8 cache's codes equal and
  scales within 1e-6 relative, and layer 0's codes and scales bit for bit
  the port's one-process ``forward``'s;
* ``generate`` and the engine with context parallelism (threshold 16, one
  prompt above it and one below) and with the pipeline forward: tokens
  equal to JAX's runs and to the port's one-process runs, on every rank;
* ``serve --pp 2`` and ``serve --cp 4`` on tests/fixtures/pyllama_10m, the
  ranks in the port's CLI: rank 0's text is the fixture's GOLDEN[:20], as
  JAX's ``test_cli_serve_pp_and_cp`` asserts; the other ranks write nothing;
* pipeline and context parallelism at once (pp 2 × cp 2 on the same two
  ranks): the stage-aware ``context_parallel_prefill`` against the
  whole-tree one over the same ranks, logits and the stage's cache layers
  bit for bit on the int8 cache and within 1e-5 in f32 (and the logits
  within 2e-4 of JAX's, as above); no rank keeps a borrowed layer past its
  turn or after the prefill; ``generate`` and the engine with the pipeline
  forward and the cp mesh: tokens equal to JAX's same runs; ``serve --pp 2
  --cp 2`` on PROMPT and on a fixture prompt over the 512-token cp
  threshold (`LONG_PROMPT`): rank 0's text the JAX CLI's, the long prompt
  in one prefill dispatch on both sides; the same pairing with ``--http``:
  rank 0's answers the JAX server's, and rank 0's server beside rank 1's
  ``follow`` ending with the same completions on both ranks, a cancel
  included; ``--pp 2 --cp 4``: refused by the
  port before any rank starts, where the JAX CLI fails on the long
  prompt with JAX's own error (pinned).
"""

import ast
import contextlib
import dataclasses
import importlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.cache import QuantizedKVCache as JQKVCache
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.engine import generate as jgenerate
from metalchat_tpu.engine.serving import ContinuousBatchingEngine as JEngine
from metalchat_tpu.engine.serving import Request as JRequest
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.ops import xla as xops
from metalchat_tpu.parallel import pipeline as jpipe
from metalchat_tpu.parallel.context import context_parallel_prefill as jcp_prefill
from metalchat_tpu.parallel.ring_attention import context_parallel_attention as jring
from metalchat_tpu_torch.cache import PagedKVCache
from metalchat_tpu_torch.parallel import GridMesh, make_pipeline_forward, make_pp_mesh
from metalchat_tpu_torch.parallel import shard_cache_pp
from torch_port_util import jax_tree_to_numpy, port_config

import torch_pp_cp_worker as worker
from test_fixture_e2e import GOLDEN, PROMPT
from test_model import TINY_LLAMA

jq = importlib.import_module("metalchat_tpu.quant.quantize")

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "fixtures" / "pyllama_10m"
# tests/test_pipeline.py's CFG.
PIPE_CFG = JLlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
                        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                        max_seq_len=64, tie_word_embeddings=False)
# tests/test_parallel_serving.py's model at 4 layers (pp 2 needs an even count).
SERVE_CFG = TINY_LLAMA.replace(max_seq_len=96, num_layers=4)
WORLDS = (2, 4)
RANK_TIMEOUT_S = 150
# A fixture prompt over the engine's 512-token cp threshold: the bytes of
# eval_tokens[1000:1700] (those below 256), 12 greedy tokens.
LONG_PROMPT = bytes(int(t) for t in np.load(FIXTURE / "eval_tokens.npy")[1000:1700]
                    if t < 256).decode()
LONG_NEW, SHORT_NEW = 12, 20


def _jax_cache(cache):
    return {f.name: np.asarray(getattr(cache, f.name)) for f in dataclasses.fields(cache)}


def _sp_mesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), ("sp",))


def _jax_results(trees, data):
    """The JAX package's runs of every case, on the CPU mesh."""
    out = {}
    tokens = jnp.asarray(data["pipe_tokens"], jnp.int32)
    for world in WORLDS:
        for pp, dp, n_mb in worker.PIPE_CASES[world]:
            mesh = jpipe.make_pp_mesh(pp=pp, dp=dp, devices=jax.devices()[:pp * dp])
            fwd = jax.jit(jpipe.make_pipeline_forward(PIPE_CFG, mesh, n_microbatches=n_mb))
            logits, cache = fwd(
                jpipe.shard_params_pp(trees["pipe"], mesh),
                jpipe.shard_cache_pp(JKVCache.create(PIPE_CFG, worker.PIPE_BATCH,
                                                     worker.PIPE_CACHE, dtype=jnp.float32), mesh),
                tokens, jnp.asarray(0, jnp.int32))
            out[f"pipe_{pp}_{dp}_{n_mb}"] = {"logits": np.asarray(logits),
                                             "cache": _jax_cache(cache)}
    mesh = jpipe.make_pp_mesh(pp=2, devices=jax.devices()[:2])
    fwd = jax.jit(jpipe.make_pipeline_forward(PIPE_CFG, mesh, n_microbatches=2))
    params = jpipe.shard_params_pp(trees["pipe_w4a8"], mesh)
    cache = jpipe.shard_cache_pp(JQKVCache.create(PIPE_CFG, worker.INT8_BATCH,
                                                  worker.PIPE_CACHE), mesh)
    logits, cache = fwd(params, cache, jnp.asarray(data["int8_tokens"], jnp.int32),
                        jnp.asarray(0, jnp.int32))
    steps, offsets = [np.asarray(logits)], jnp.asarray(worker.INT8_OFFSETS, jnp.int32)
    for _ in range(worker.INT8_STEPS):
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        logits, cache = fwd(params, cache, tok, offsets)
        steps.append(np.asarray(logits))
        offsets = offsets + 1
    out["pipe_int8"] = {"logits": steps, "cache": _jax_cache(cache)}

    q, k, v = (jnp.asarray(data["ring"][n]) for n in "qkv")
    b, s = q.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    for causal in (True, False):
        mask = xops.causal_mask(positions, s, s) if causal else jnp.ones((b, s, s), bool)
        out[f"ring_dense_{causal}"] = np.asarray(xops.attention(q, k, v, mask, scale=0.25))
        for world in WORLDS:
            out[f"ring_{world}_{causal}"] = np.asarray(
                jring(q, k, v, _sp_mesh(world), "sp", scale=0.25, causal=causal))

    cp_tokens = jnp.asarray(data["cp_tokens"], jnp.int32)
    b = cp_tokens.shape[0]
    for world in WORLDS:
        for quantized in (False, True):
            cache = (JQKVCache.create(SERVE_CFG, b, worker.SERVE_CACHE) if quantized else
                     JKVCache.create(SERVE_CFG, b, worker.SERVE_CACHE, dtype=jnp.float32))
            mesh = _sp_mesh(world)
            logits, cache = jax.jit(lambda p, c, t: jcp_prefill(p, c, t, SERVE_CFG, mesh))(
                trees["serve"], cache, cp_tokens)
            out[f"cp_prefill_{world}_{quantized}"] = {"logits": np.asarray(logits),
                                                      "cache": _jax_cache(cache)}

    serve = trees["serve"]

    def dense(batch):
        return JKVCache.create(SERVE_CFG, batch, worker.SERVE_CACHE, dtype=jnp.float32)

    def engine_tokens(engine, prompts, new):
        reqs = [JRequest(prompt=p, max_new_tokens=new) for p in prompts]
        done = engine.run(reqs)
        return [done[r.request_id].tokens for r in reqs]

    sp4 = _sp_mesh(4)
    out["cp_generate"] = np.asarray(jgenerate(
        serve, SERVE_CFG, jnp.asarray([worker.CP_PROMPT], jnp.int32),
        max_new_tokens=worker.CP_NEW, cache=dense(1), context_parallel_mesh=sp4)).tolist()
    out["cp_engine"] = engine_tokens(
        JEngine(serve, SERVE_CFG, max_slots=2, max_seq_len=worker.SERVE_CACHE,
                context_parallel_mesh=sp4, context_parallel_threshold=worker.CP_THRESHOLD),
        worker.CP_ENGINE_PROMPTS, worker.CP_ENGINE_NEW)
    pmesh = jpipe.make_pp_mesh(pp=2, devices=jax.devices()[:2])
    pf = jpipe.make_pipeline_forward(SERVE_CFG, pmesh, n_microbatches=1)
    pparams = jpipe.shard_params_pp(serve, pmesh)
    out["pp_generate"] = np.asarray(jgenerate(
        pparams, SERVE_CFG, jnp.asarray([worker.PP_PROMPT], jnp.int32),
        max_new_tokens=worker.PP_NEW, cache=jpipe.shard_cache_pp(dense(1), pmesh),
        forward_fn=pf)).tolist()
    out["pp_engine"] = engine_tokens(
        JEngine(pparams, SERVE_CFG, max_slots=2, max_seq_len=worker.SERVE_CACHE,
                forward_fn=pf, cache=jpipe.shard_cache_pp(dense(2), pmesh)),
        worker.PP_ENGINE_PROMPTS, worker.PP_ENGINE_NEW)
    sp2 = _sp_mesh(2)
    out["pp_cp_generate"] = np.asarray(jgenerate(
        pparams, SERVE_CFG, jnp.asarray([worker.CP_PROMPT], jnp.int32),
        max_new_tokens=worker.CP_NEW, cache=jpipe.shard_cache_pp(dense(1), pmesh),
        forward_fn=pf, context_parallel_mesh=sp2)).tolist()
    out["pp_cp_engine"] = engine_tokens(
        JEngine(pparams, SERVE_CFG, max_slots=2, max_seq_len=worker.SERVE_CACHE,
                forward_fn=pf, cache=jpipe.shard_cache_pp(dense(2), pmesh),
                context_parallel_mesh=sp2, context_parallel_threshold=worker.CP_THRESHOLD),
        worker.CP_ENGINE_PROMPTS, worker.CP_ENGINE_NEW)
    return out


def _jax_cli(home: Path, argv):
    """The JAX CLI in this process: (exit code or the exception it raised,
    its JSONL lines, its served-requests summary)."""
    from metalchat_tpu.cli.main import main

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("METALCHAT_TPU_HOME", str(home))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except Exception as e:  # noqa: BLE001 — the failure is the result
                rc = e
    summary = re.search(r"served \d+ requests: (\{.*\})", err.getvalue())
    return (rc, [json.loads(line) for line in out.getvalue().splitlines() if line.strip()],
            ast.literal_eval(summary.group(1)) if summary else None)


def _jax_http(home: Path, argv, prompts):
    """The JAX CLI's ``serve --http`` in this process: once it sleeps behind
    its server, each (prompt, max_tokens) is posted to /v1/completions and
    the sleep ends as a Ctrl-C would end it. (exit code, the answers)."""
    from metalchat_tpu.engine.http import InferenceServer as JServer

    real_start, real_sleep, box, answers = JServer.start, time.sleep, {}, []

    def start(self, host="127.0.0.1", port=0):
        box["port"] = real_start(self, host, port)
        return box["port"]

    def sleep(seconds):
        if seconds != 3600:  # the server's own threads
            return real_sleep(seconds)
        for prompt, n in prompts:
            body = json.dumps({"prompt": prompt, "max_tokens": n, "temperature": 0.0}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{box['port']}/v1/completions",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read())["choices"][0]["text"])
        raise KeyboardInterrupt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JServer, "start", start)
        mp.setattr(time, "sleep", sleep)
        rc, _, _ = _jax_cli(home, argv)
    return rc, answers


def _jax_cli_results(data):
    """The JAX CLI with ``--pp 2 --cp 2`` (JSONL and HTTP) and ``--pp 2
    --cp 4`` on the fixture, on the CPU mesh."""
    home, args = Path(data["cli_home"]), ["--slots", "2", "--max-seq-len", "1024"]
    out = {}
    for name, path in (("short", data["cli_input"]), ("long", data["cli_long_input"])):
        out[f"cli_pp_cp_{name}"] = _jax_cli(home, ["serve", "pyllama", "--input", path, *args,
                                                  "--pp", "2", "--cp", "2"])
    out["cli_pp2_cp4_long"] = _jax_cli(home, ["serve", "pyllama", "--input",
                                              data["cli_long_input"], *args, "--pp", "2",
                                              "--cp", "4"])
    out["http_pp_cp"] = _jax_http(home, ["serve", "pyllama", *args, "--pp", "2", "--cp", "2",
                                         "--http", "0"], data["http_prompts"])
    return out


def _pull_fixture(home: Path) -> None:
    """The fixture in a store under ``home``, through the port's CLI."""
    from metalchat_tpu_torch.cli.main import main

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("METALCHAT_TPU_HOME", str(home))
        assert main(["model", "pull", str(FIXTURE), "--name", "pyllama"]) == 0


def _launch(tmp: Path, world: int):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(HERE / "torch_pp_cp_worker.py"), str(r), str(world),
         str(tmp / f"store{world}"), str(tmp / "inputs.pkl"), str(tmp / f"w{world}r{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _collect(procs, tmp: Path, world: int, deadline: float):
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
        assert p.returncode == 0 and f"OK {r}" in log, f"{world} ranks: rank {r} failed:\n{log}"
    out = []
    for r in range(world):
        with open(tmp / f"w{world}r{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, {world: the port's per-rank results})."""
    tmp = tmp_path_factory.mktemp("pp_cp")
    trees = {"pipe": jinit(PIPE_CFG, seed=0, dtype=jnp.float32),
             "pipe_w4a8": jq.quantize_params(jinit(PIPE_CFG, seed=2, dtype=jnp.float32),
                                             bits=4, group_size=None, act_bits=8,
                                             scales_dtype=jnp.float32),
             "serve": jinit(SERVE_CFG, seed=11, dtype=jnp.float32)}
    rng = np.random.default_rng(0)
    data = {"pipe_cfg": dataclasses.asdict(port_config(PIPE_CFG)),
            "serve_cfg": dataclasses.asdict(port_config(SERVE_CFG)),
            "pipe_tokens": rng.integers(0, PIPE_CFG.vocab_size,
                                        (worker.PIPE_BATCH, worker.PIPE_LEN)).tolist(),
            "int8_tokens": rng.integers(0, PIPE_CFG.vocab_size,
                                        (worker.INT8_BATCH, worker.PIPE_LEN)).tolist(),
            "ring": {n: rng.standard_normal(shape).astype(np.float32) for n, shape in
                     (("q", (2, 32, 8, 16)), ("k", (2, 4, 32, 16)), ("v", (2, 4, 32, 16)))},
            "cp_tokens": rng.integers(0, SERVE_CFG.vocab_size, (2, 40)).tolist(),
            "cli_home": str(tmp / "home"), "cli_input": str(tmp / "reqs.jsonl"),
            "cli_long_input": str(tmp / "long.jsonl"),
            "http_prompts": [(LONG_PROMPT, LONG_NEW), (PROMPT.decode(), SHORT_NEW)],
            **{k: jax_tree_to_numpy(v) for k, v in trees.items()}}
    _pull_fixture(tmp / "home")
    (tmp / "reqs.jsonl").write_text(json.dumps(
        {"prompt": PROMPT.decode(), "max_tokens": SHORT_NEW, "temperature": 0.0}) + "\n")
    (tmp / "long.jsonl").write_text(json.dumps(
        {"prompt": LONG_PROMPT, "max_tokens": LONG_NEW, "temperature": 0.0}) + "\n")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(data, f)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    launches = {world: _launch(tmp, world) for world in WORLDS}
    try:
        want = {**_jax_results(trees, data), **_jax_cli_results(data)}
    finally:
        ranks = {world: _collect(procs, tmp, world, deadline)
                 for world, procs in launches.items()}
    return want, ranks, data


def _assemble(ranks, case, dp):
    """The ranks' local caches joined: stages along the layer axis, dp rows
    along the batch axis."""
    rows = []
    for d in range(dp):
        stages = sorted((r[case] for r in ranks if r[case]["row"] == d),
                        key=lambda c: c["stage"])
        rows.append({n: np.concatenate([c["cache"][n] for c in stages], axis=0)
                     for n in stages[0]["cache"]})
    return {n: np.concatenate([r[n] for r in rows], axis=1) for n in rows[0]}


PIPE_PARAMS = [(w, c) for w in WORLDS for c in worker.PIPE_CASES[w]]


@pytest.mark.parametrize("world,case", PIPE_PARAMS,
                         ids=[f"pp{c[0]}-dp{c[1]}-mb{c[2]}" for _, c in PIPE_PARAMS])
def test_pipeline_prefill(runs, world, case):
    want, ranks, _ = runs
    pp, dp, n_mb = case
    name = f"pipe_{pp}_{dp}_{n_mb}"
    got = ranks[world]
    for r in got:
        np.testing.assert_array_equal(r[name]["logits"], got[0][name]["logits"])
    np.testing.assert_allclose(got[0][name]["logits"], want[name]["logits"], atol=2e-4)
    cache = _assemble(got, name, dp)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n], want[name]["cache"][n], atol=1e-5)
    if n_mb == 1 and dp == 1:
        ref = got[0][name]["ref"]
        np.testing.assert_array_equal(got[0][name]["logits"], ref["logits"])
        for n in ("k", "v"):
            np.testing.assert_array_equal(cache[n], ref["cache"][n])
    ticks = n_mb + pp - 1
    want_moves = {"handoff_pp": ticks - 1, "broadcast_pp": 1, **(
        {"all_gather_dp": 1} if dp > 1 else {})}
    for r in got:
        assert r[name]["collectives"] == want_moves


def test_pipeline_int8_per_row_offsets(runs):
    want, ranks, _ = runs
    got = ranks[2]
    w = want["pipe_int8"]
    for step, (g, j) in enumerate(zip(got[0]["pipe_int8"]["logits"], w["logits"])):
        np.testing.assert_allclose(g, j, atol=1e-5, err_msg=f"step {step}")
        for r in got[1:]:
            np.testing.assert_array_equal(r["pipe_int8"]["logits"][step], g)
    cache = {n: np.concatenate([r["pipe_int8"]["cache"][n] for r in got], axis=0)
             for n in got[0]["pipe_int8"]["cache"]}
    for n in ("k", "v"):
        np.testing.assert_array_equal(cache[n], w["cache"][n])
    for n in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[n], w["cache"][n], rtol=1e-6)


def test_pipeline_guards():
    """JAX's refusals, with JAX's messages; no ranks needed."""
    cfg = port_config(PIPE_CFG)
    with pytest.raises(ValueError, match="not divisible by pp"):
        make_pipeline_forward(cfg, GridMesh({"dp": 1, "pp": 3}))
    fwd = make_pipeline_forward(cfg, make_pp_mesh(1), n_microbatches=3)
    from metalchat_tpu_torch.cache import KVCache
    from metalchat_tpu_torch.convert import params_from_numpy

    params = params_from_numpy(jax_tree_to_numpy(jinit(PIPE_CFG, seed=0, dtype=jnp.float32)),
                               "cpu")
    cache = KVCache.create(cfg, 4, 32, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="per-dp batch not divisible by 3 microbatches"):
        fwd(params, cache, torch.zeros((4, 8), dtype=torch.long), 0)
    with pytest.raises(ValueError, match=r"dp\*pp = 1\*2 != 1 processes"):
        make_pp_mesh(2)
    paged = PagedKVCache.create(cfg, num_pages=4, page_size=16, max_slots=1,
                                max_pages_per_seq=4, device="cpu")
    with pytest.raises(NotImplementedError, match="dense or int8"):
        shard_cache_pp(paged, GridMesh({"dp": 1, "pp": 2}, rank=1))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention(runs, world, causal):
    want, ranks, _ = runs
    for r in ranks[world]:
        got = r[f"ring_{causal}"]
        np.testing.assert_allclose(got, want[f"ring_{world}_{causal}"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want[f"ring_dense_{causal}"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_cp_prefill(runs, world, quantized):
    want, ranks, data = runs
    w = want[f"cp_prefill_{world}_{quantized}"]
    s = len(data["cp_tokens"][0])
    n_layers = SERVE_CFG.num_layers
    for r in ranks[world]:
        got = r[f"cp_prefill_{quantized}"]
        np.testing.assert_allclose(got["logits"], w["logits"], rtol=2e-4, atol=2e-4)
        if quantized:
            for n in ("k", "v"):
                np.testing.assert_array_equal(got["cache"][n][..., :s, :],
                                              w["cache"][n][..., :s, :])
            for n in ("k_scale", "v_scale"):
                np.testing.assert_allclose(got["cache"][n][..., :s], w["cache"][n][..., :s],
                                           rtol=1e-6)
            ref = ranks[world][0][f"cp_prefill_{quantized}"]["ref_layer0"]
            for n in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(got["cache"][n][0, ..., :s], ref[n])
        else:
            for n in ("k", "v"):
                np.testing.assert_allclose(got["cache"][n][..., :s, :],
                                           w["cache"][n][..., :s, :], rtol=2e-4, atol=2e-4)
        assert got["collectives"] == {"rotate_sp": n_layers * (world - 1),
                                      "all_gather_sp": n_layers, "broadcast_sp": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_cp_generate_and_engine(runs, world):
    want, ranks, _ = runs
    ref = ranks[world][0]["cp_serving"]
    assert ref["ref_generate"] == want["cp_generate"]
    assert ref["ref_engine"] == want["cp_engine"]
    for r in ranks[world]:
        got = r["cp_serving"]
        assert got["generate"] == want["cp_generate"]
        assert got["engine"] == want["cp_engine"]
        assert got["engine_cp_prefills"] == {(1, len(worker.CP_ENGINE_PROMPTS[0])): 1}


def test_pp_generate_and_engine(runs):
    want, ranks, _ = runs
    ref = ranks[2][0]["pp_serving"]
    assert ref["ref_generate"] == want["pp_generate"]
    assert ref["ref_engine"] == want["pp_engine"]
    for r in ranks[2]:
        assert r["pp_serving"]["generate"] == want["pp_generate"]
        assert r["pp_serving"]["engine"] == want["pp_engine"]


CLI_CASES = {"pp2": (2, "cli"), "cp4": (4, "cli"), "pp2-cp2-short": (2, "cli_pp_cp_short"),
             "pp2-cp2-long": (2, "cli_pp_cp_long")}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_serve_pp_and_cp(runs, case):
    """Rank 0's text: the fixture's GOLDEN[:20] for PROMPT (JAX's
    ``test_cli_serve_pp_and_cp``), and with ``--pp 2 --cp 2`` the JAX CLI's
    own text; the long prompt in one (context-parallel) prefill dispatch on
    both sides."""
    want, ranks, _ = runs
    world, name = CLI_CASES[case]
    root, *others = (r[name] for r in ranks[world])
    assert root["rc"] == 0 and len(root["lines"]) == 1
    assert all(o["rc"] == 0 and o["lines"] == [] for o in others)
    if name == "cli":
        assert root["lines"][0]["text"] == bytes(GOLDEN[:20]).decode()
        return
    rc, lines, summary = want[name]
    assert rc == 0 and len(lines) == 1
    assert root["lines"][0]["text"] == lines[0]["text"]
    if name == "cli_pp_cp_short":
        assert lines[0]["text"] == bytes(GOLDEN[:20]).decode()
    else:
        assert root["summary"]["prefill_dispatches"] == summary["prefill_dispatches"] == 1


@pytest.mark.parametrize("world", WORLDS[:1])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_pp_cp_prefill(runs, world, quantized):
    """The stage-aware ring prefill against the whole-tree one over the
    same ranks: bit for bit on the int8 cache, within 1e-5 in f32; within
    2e-4 of JAX's logits; one layer hand-off a layer; no rank keeps a
    borrowed layer past its turn, or any after the prefill, and each keeps
    only its stage's layers."""
    want, ranks, data = runs
    s = len(data["cp_tokens"][0])
    per = SERVE_CFG.num_layers // 2
    for r in ranks[world]:
        got = r[f"pp_cp_prefill_{quantized}"]
        if quantized:
            np.testing.assert_array_equal(got["logits"], got["whole_logits"])
            for n in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(got["cache"][n][..., :s],
                                              got["whole_stage"][n][..., :s])
        else:
            np.testing.assert_allclose(got["logits"], got["whole_logits"], rtol=1e-5, atol=1e-5)
            for n in ("k", "v"):
                np.testing.assert_allclose(got["cache"][n][..., :s, :],
                                           got["whole_stage"][n][..., :s, :], rtol=1e-5,
                                           atol=1e-5)
        np.testing.assert_allclose(got["logits"], want[f"cp_prefill_{world}_{quantized}"]["logits"],
                                   rtol=2e-4, atol=2e-4)
        n_layers = SERVE_CFG.num_layers
        assert got["collectives"] == {"rotate_sp": n_layers * (world - 1),
                                      "all_gather_sp": n_layers, "broadcast_sp": 1,
                                      "layer_broadcast_sp": n_layers}
        assert got["borrowed"] == n_layers
        assert got["alive_at_next"] == [0] * n_layers and got["alive_after"] == 0
        assert set(got["stage_layers"].values()) == {per}


def test_pp_cp_generate_and_engine(runs):
    """`generate` and the engine with the pipeline forward and the cp mesh
    over the same two ranks: JAX's tokens on every rank, the long prompt
    through one ring prefill."""
    want, ranks, _ = runs
    for r in ranks[2]:
        got = r["pp_cp_serving"]
        assert got["generate"] == want["pp_cp_generate"]
        assert got["engine"] == want["pp_cp_engine"]
        assert got["engine_cp_prefills"] == {(1, len(worker.CP_ENGINE_PROMPTS[0])): 1}


def test_cli_serve_pp_cp_http(runs):
    """``serve --pp 2 --cp 2 --http 0``: rank 0's answers to the long
    prompt and to PROMPT are the JAX server's; both ranks exit 0 once rank
    0's server stops."""
    want, ranks, _ = runs
    rc, answers = want["http_pp_cp"]
    assert rc == 0 and len(answers) == 2 and answers[1] == bytes(GOLDEN[:20]).decode()
    root, other = (r["http_pp_cp"] for r in ranks[2])
    assert root["rc"] == 0 and other["rc"] == 0
    assert root["answers"] == answers


def test_http_follow_lockstep(runs):
    """Rank 0's `InferenceServer(mesh=)` and rank 1's `follow`: the same
    completions on both ranks, the cancel included (applied in the same
    round on both); the short request's tokens JAX's pipeline `generate`'s,
    the cancelled one cut short."""
    want, ranks, _ = runs
    root, other = (r["http_follow"] for r in ranks[2])
    assert root == other
    (long_tokens, long_reason), (short_tokens, short_reason) = root
    assert long_reason == "cancelled" and 2 <= len(long_tokens) < worker.HTTP_LONG_NEW
    assert short_reason == "length" and short_tokens == want["pp_generate"][0]


def test_cli_serve_pp_cp_unequal(runs, monkeypatch):
    """``--pp 2 --cp 4``: the JAX CLI serves short prompts but fails on the
    first one over its cp threshold (its cp mesh holds devices the
    pipeline's params are not on); the port refuses the pairing before
    any rank starts."""
    from metalchat_tpu_torch.cli.main import main

    want, _, data = runs
    rc, lines, _ = want["cli_pp2_cp4_long"]
    assert isinstance(rc, ValueError) and lines == []
    assert "Received incompatible devices for jitted computation" in str(rc)
    monkeypatch.setenv("METALCHAT_TPU_HOME", data["cli_home"])
    with pytest.raises(SystemExit, match=r"--pp 2 --cp 4: .* give --cp equal to --pp"):
        main(["serve", "pyllama", "--input", data["cli_long_input"], "--pp", "2", "--cp", "4",
              "--device", "cpu"])
