"""The port's sharded train step on MoE trees (``make_train_step(..., mesh=)``
over ("dp", "ep", "tp"): experts over ep, their FFN width over tp, the
batch's rows over dp) against the JAX package on the CPU.

Two launches of rank processes (tests/torch_train_moe_worker.py, which
imports torch, numpy and the port only), one after the other, run over
gloo through a ``file://`` store while the JAX side of their cases runs
here. Eight ranks run (a) dp 2 × ep 2 × tp 2, (b) dp 4 × ep 2 and (c) ep 4
× tp 2; four ranks run (d) dp 2 × ep 2. The tree is `CFG`, a Mixtral of 4
experts, top 2, hidden 64, FFN 128, 2 layers, f32, its capacity factor 0.5,
so that JAX's dispatch over the whole batch of 4 × 16 tokens drops pairs
and a dp row's rows alone would route otherwise (JAX's step is one program
over the whole batch: its capacity, slots, scheme and load-balancing loss
are the whole batch's, and the port's ranks gather their routing counts
over dp to compute the same).

Every case is held twice (the bounds are those of JAX's own sharded test,
tests/test_train.py:183-186, and of tests/test_torch_train_sharded.py):

* against the port's own one-device step on the same inputs, which is what
  the sharding must not move: every loss rtol 1e-6, the first step's
  gradients atol 2e-6 (only the order of f32 sums differs, and a bf16
  rounding of k's or v's gradient in the loss's cache that it flips:
  measured 1.15e-6 on (c)'s embedding, whose rows sum many positions'
  gradients, 7.9e-7 on (a)'s wv), SGD's leaves atol 1e-6 after 3 steps, Adam's every element
  within a tenth of the lr and the L1 distance within 1e-3 of the distance
  the leaves moved (Adam divides each element's step by its own gradient's
  root mean square, so an element whose gradient sits at the f32 noise
  moves by a share of the lr whatever its exact value);
* against JAX's one device: the first loss rtol 1e-6 and ``grad_norm``
  rtol 1e-5; the first step's gradients atol 1e-5 (LoRA's plus 2^-9 of the
  leaf's largest); SGD's losses rtol 1e-6, and each leaf (and (b)'s router
  gradient) within 1e-6 of JAX's beyond the port's own one-device distance
  from it; Adam's losses rtol 1e-4 and leaves by
  `test_torch_train.assert_leaves_close` (L1 within 1% of JAX's movement).
  The loss writes k and v into a bf16 cache, whose rounding also rounds
  their gradients, so the port's one device stands off JAX's by bf16 steps
  that f32 sums in another order flip: up to 1.24e-6 on (b)'s router
  gradient, 1.2e-6 on its leaves after 3 SGD steps, 5.8e-5 on (d)'s first
  adaptor gradients and 5.7e-3 on its leaves after 3 Adam steps. With the
  cache in f32 on both sides (a check made while writing this test) the
  one-device gradients agree to 1e-8; (a) meets JAX's 1e-6 on every loss
  and leaf, and JAX's own dp 2 × ep 2 × tp 2 mesh too.

The first step's routing slots are the same integers as JAX's, read off
JAX's dispatch buffer. Metrics and gathered leaves are equal on every rank
of a case.
"""

import dataclasses
import functools
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
import optax

from metalchat_tpu import train as jt
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.config import MixtralConfig as JMixtralConfig
from metalchat_tpu.models import forward as jforward
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.models import moe as jmoe
from metalchat_tpu.parallel import mesh as jmesh
from metalchat_tpu.quant.quantize import LoraLinear as JLoraLinear
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch import train as tt
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.parallel import Mesh, gather_leaf, leaf_ep_axis, shard_leaf
from metalchat_tpu_torch.train.tree import DictKey, tree_flatten_with_path
from torch_port_util import jax_tree_to_numpy, port_config

import torch_train_worker as worker
from test_torch_train import assert_leaves_close

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 150
CPU = torch.device("cpu")
CFG = JMixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=32,
                     tie_word_embeddings=False, num_experts=4, num_experts_per_tok=2,
                     expert_capacity_factor=0.5)
SGD = (lambda: optax.sgd(1e-2), "sgd")
ADAM = (lambda: optax.adam(5e-3), "adam")
LOSS_RTOL, LEAF_ATOL = 1e-6, 1e-6
STEPS = 3


def make_batch(seed, b=4, s=17):
    """``b`` rows of ``s - 1`` inputs: 64 tokens at the defaults."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32),
            "loss_mask": np.ones((b, s - 1), np.float32)}


def _cfg_entry(jcfg):
    cfg = port_config(jcfg)
    return type(cfg).__name__, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _lora_attention(seed):
    """Dense experts, rank-4 adaptors on wq/wk/wv/wo (``b`` non-zero, so the
    first step's ``a`` gradients count)."""
    jp = jt.attach_lora(jinit(CFG, seed=seed, dtype=jnp.float32), rank=4, seed=seed,
                        targets=("wq", "wk", "wv", "wo"))
    rng = np.random.default_rng(seed)
    layers = {k: dataclasses.replace(v, b=jnp.asarray(
        rng.standard_normal(v.b.shape) * 0.02, jnp.float32))
        if isinstance(v, JLoraLinear) else v for k, v in jp["layers"].items()}
    return dict(jp, layers=layers)


def _cases(tmp):
    """{world: {case: (JAX tree, JAX optimizer, predicate, the worker's case)}}."""
    out = {8: {}, 4: {}}

    def case(world, name, jp, opt, pred, batches, mesh, aux, **extra):
        out[world][name] = (jp, opt[0], pred, dict(
            kind="train", cfg=_cfg_entry(CFG), tree=jax_tree_to_numpy(jp), opt=opt[1],
            pred="full" if pred is jt.trainable_full else "lora", batches=batches, mesh=mesh,
            aux=aux, layers=CFG.num_layers, **extra))

    case(8, "a_dp2_ep2_tp2", jinit(CFG, seed=3, dtype=jnp.float32), SGD, jt.trainable_full,
         [make_batch(3)] * STEPS, dict(dp=2, ep=2, tp=2), 0.01,
         path=str(tmp / "moe_state.safetensors"))
    case(8, "b_dp4_ep2", jinit(CFG, seed=4, dtype=jnp.float32), SGD, jt.trainable_full,
         [make_batch(4)] * STEPS, dict(dp=4, ep=2, tp=1), 1.0)
    case(8, "c_int8_ep4_tp2",
         jquantize_params(jinit(CFG, seed=5, dtype=jnp.float32), bits=8, group_size=32),
         ADAM, jt.trainable_full, [make_batch(5)] * STEPS, dict(dp=1, ep=4, tp=2), 0.01)
    case(4, "d_lora_dp2_ep2", _lora_attention(6), ADAM, jt.trainable_lora,
         [make_batch(6)] * STEPS, dict(dp=2, ep=2, tp=1), 0.01)
    return out


@functools.partial(jax.jit, static_argnames=("spec", "aux"))
def _jax_loss_and_grads(trainable, frozen, batch, spec, aux):
    """JAX's ``make_train_step`` loss and gradients on one device
    (``causal_lm_loss`` with ``moe_aux_weight``)."""
    return jax.value_and_grad(lambda tr: jt.causal_lm_loss(
        jt.combine(tr, frozen, spec), batch["tokens"], batch["loss_mask"], CFG,
        moe_aux_weight=aux))(trainable)


def _jax_step(opt, spec, aux, state, frozen, batch):
    loss, grads = _jax_loss_and_grads(state.trainable, frozen,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      spec=spec, aux=aux)
    updates, opt_state = opt.update(grads, state.opt_state, state.trainable)
    return jt.TrainState(optax.apply_updates(state.trainable, updates), opt_state,
                         state.step + 1), float(loss), grads


def _jax_train(jp, opt, pred, batches, aux):
    """JAX's one device: every step's loss and grad_norm, the first step's
    gradients, the final leaves, and what a resumed step needs."""
    t, f, spec = jt.partition(jp, pred)
    opt = opt()
    init, _ = jt.make_train_step(CFG, opt, spec)
    state, losses, norms, first = init(t), [], [], None
    for batch in batches:
        state, loss, grads = _jax_step(opt, spec, aux, state, f, batch)
        first = grads if first is None else first
        losses.append(loss)
        norms.append(float(optax.global_norm(grads)))
    return {"losses": losses, "norms": norms, "grads": [np.asarray(g) for g in first],
            "leaves": [np.asarray(x) for x in state.trainable], "init": init,
            "step": functools.partial(_jax_step, opt, spec, aux), "frozen": f,
            "trainable": t}


def _jax_mesh_train(jp, opt, batches, aux):
    """JAX's own dp 2 × ep 2 × tp 2 mesh: ``shard_params``, the batch on
    ``P("dp")``, its jitted step; every loss and the final leaves."""
    mesh = jmesh.make_mesh(tp=2, dp=2, ep=2, devices=jax.devices()[:8])
    t, f, spec = jt.partition(jmesh.shard_params(jp, CFG, mesh), jt.trainable_full)
    init, step = jt.make_train_step(CFG, opt(), spec, loss_fn=functools.partial(
        jt.causal_lm_loss, moe_aux_weight=aux))
    rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))
    state, losses = init(t), []
    for batch in batches:
        state, m = step(state, f, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                                 rows))
        losses.append(float(m["loss"]))
    return {"losses": losses, "leaves": [np.asarray(x) for x in state.trainable]}


def _jax_slots(jp, batch):
    """JAX's dispatch slots a layer over the whole batch, read off its own
    dispatch buffer: its loss's forward (jitted, no remat) with
    ``moe._moe_dispatch`` wrapped to hand each layer's tokens, routing and
    the expert buffer ``_expert_mlp`` receives to an ordered
    ``jax.debug.callback``; a (token, choice)'s slot is the buffer row of
    its expert that holds the token (every token's activation is distinct,
    checked), ``capacity`` where none does (dropped). Returns [(slot [T, K],
    capacity)] a layer."""
    plain_dispatch, plain_mlp = jmoe._moe_dispatch, jmoe._expert_mlp
    seen = []

    def dispatch(xt, layer, config):
        bufs = []

        def mlp(xin, layer_, config_):
            bufs.append(xin)
            return plain_mlp(xin, layer_, config_)

        jmoe._expert_mlp = mlp
        try:
            out = plain_dispatch(xt, layer, config)
        finally:
            jmoe._expert_mlp = plain_mlp
        jax.debug.callback(lambda *a: seen.append(tuple(np.asarray(x) for x in a)), xt,
                           jmoe._route(xt, layer["router"], config)[2], bufs[0], ordered=True)
        return out

    jmoe._moe_dispatch = dispatch
    try:
        loss = jax.jit(lambda p, t, m: jt.causal_lm_loss(p, t, m, CFG, remat=False))(
            jp, jnp.asarray(batch["tokens"]), jnp.asarray(batch["loss_mask"]))
        jax.block_until_ready(loss)
        jax.effects_barrier()
    finally:
        jmoe._moe_dispatch = plain_dispatch
    out = []
    for xt, idx, xin in seen:
        assert len(np.unique(xt, axis=0)) == len(xt)  # the premise: tokens tell apart
        cap = xin.shape[1]
        slot = np.full(idx.shape, cap)
        for t, j in np.ndindex(*idx.shape):
            hits = np.flatnonzero((xin[idx[t, j]] == xt[t]).all(-1))
            assert len(hits) <= 1
            if len(hits):
                slot[t, j] = hits[0]
        out.append((slot, cap))
    return out


def _jax_rows_alone(jp, batch, rows):
    """JAX's differentiable forward over the whole batch and over its first
    ``rows`` rows alone: those rows' f32 logits both ways."""
    tokens = jnp.asarray(batch["tokens"][:, :-1])

    def logits(t):
        cache = JKVCache.create(CFG, batch_size=t.shape[0], max_seq_len=t.shape[1])
        return np.asarray(jforward(jp, cache, t, 0, CFG, differentiable=True)[0])

    return logits(tokens)[:rows], logits(tokens[:rows])


def _launch(world, tmp, inputs):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_DYNAMIC="FALSE", OMP_DYNAMIC="FALSE")
    return [subprocess.Popen(
        [sys.executable, str(HERE / "torch_train_moe_worker.py"), str(r), str(world),
         str(tmp / f"store{world}"), str(inputs), str(tmp / f"w{world}_rank{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX results, {case: every rank's result}, the cases)."""
    tmp = tmp_path_factory.mktemp("train_moe_sharded")
    cases = _cases(tmp)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({w: {n: c[3] for n, c in cases[w].items()} for w in cases}, f)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    procs, logs, want = {}, {}, {}
    try:  # one launch at a time, each while the JAX side of its cases runs
        for w in (8, 4):
            procs[w] = _launch(w, tmp, tmp / "inputs.pkl")
            for name, (jp, opt, pred, case) in cases[w].items():
                want[name] = _jax_train(jp, opt, pred, case["batches"], case["aux"])
                want[name]["one"] = _port_one_device(jp, case)
            if w == 8:
                jp, opt, _, case = cases[8]["a_dp2_ep2_tp2"]
                want["a_mesh"] = _jax_mesh_train(jp, opt, case["batches"], case["aux"])
                want["a_slots"] = _jax_slots(jp, case["batches"][0])
                want["a_rows"] = _jax_rows_alone(jp, case["batches"][0], 2)
                jp, _, _, case = cases[8]["b_dp4_ep2"]
                want["b_slots"] = _jax_slots(jp, case["batches"][0])
            logs[w] = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                       for p in procs[w]]
    finally:
        for ps in procs.values():  # a rank that hangs is killed, and the launch fails
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    ranks = {}
    for w, ps in procs.items():
        for r, (p, log) in enumerate(zip(ps, logs[w])):
            assert p.returncode == 0 and f"OK {r}" in log, f"{w} ranks: rank {r} failed:\n{log}"
        results = []
        for r in range(w):
            with open(tmp / f"w{w}_rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        ranks.update({n: [res[n] for res in results] for n in cases[w]})
    return want, ranks, {n: c for w in cases for n, c in cases[w].items()}


def _trained_paths(jp, pred):
    """The trainable leaves' paths (as ``keystr`` prints them)."""
    tree = params_from_numpy(jax_tree_to_numpy(jp), CPU)
    with_path = tree_flatten_with_path(tree)[0]
    flags = tt.partition(tree, pred)[2][1]
    return [''.join(map(str, p)) for (p, _), f in zip(with_path, flags) if f]


def _port_one_device(jp, case):
    """The port's own one-device steps on the same inputs: every loss, the
    first step's gradients, the final leaves."""
    t, f, spec = tt.partition(params_from_numpy(jax_tree_to_numpy(jp), CPU),
                              worker.PREDICATES[case["pred"]])
    init, step = tt.make_train_step(port_config(CFG), worker.OPTIMIZERS[case["opt"]], spec,
                                    loss_fn=worker.loss_fn(case))
    state, losses, grads = init(t), [], None
    for batch in case["batches"]:
        state, m = step(state, f, batch)
        losses.append(float(m["loss"]))
        grads = grads or [p.grad.numpy().copy() for p in state.trainable]
    return {"losses": losses, "grads": grads,
            "leaves": [x.detach().numpy() for x in state.trainable]}


def _hold(runs, name):
    """The module docstring's bounds for case ``name``: against the port's
    one device and against JAX's; metrics, collectives and gathered leaves
    equal on every rank. Returns (rank 0's result, JAX's, the one
    device's)."""
    want, ranks, cases = runs
    jp, opt, pred, case = cases[name]
    got, jw, one = ranks[name][0], want[name], want[name]["one"]
    adam, lora = case["opt"] == "adam", pred is jt.trainable_lora
    losses = [m["loss"] for m in got["metrics"]]
    assert [m["step"] for m in got["metrics"]] == list(range(1, STEPS + 1))
    np.testing.assert_allclose(losses, one["losses"], rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(losses[0], jw["losses"][0], rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(losses, jw["losses"], rtol=1e-4 if adam else 1e-6, err_msg=name)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], jw["norms"][0], rtol=1e-5)
    assert len(got["grads"]) == len(jw["grads"]) == len(one["grads"]) == len(got["leaves"])
    for i, (g, o, w) in enumerate(zip(got["grads"], one["grads"], jw["grads"])):
        np.testing.assert_allclose(g, o, atol=2e-6, err_msg=f"{name} {i}")
        np.testing.assert_allclose(g, w, atol=1e-5 + (2 ** -9 * np.abs(w).max() if lora else 0),
                                   err_msg=f"{name} gradient {i}")
    if adam:
        lr = 5e-3
        start = [np.asarray(x) for x in jt.partition(jp, pred)[0]]
        for g, o in zip(got["leaves"], one["leaves"]):
            np.testing.assert_allclose(g, o, atol=lr / 10)
        assert_leaves_close(got["leaves"], one["leaves"], start, share=1e-3)
        assert_leaves_close(got["leaves"], jw["leaves"], start)
    else:
        for i, (g, o, w) in enumerate(zip(got["leaves"], one["leaves"], jw["leaves"])):
            np.testing.assert_allclose(g, o, atol=LEAF_ATOL, err_msg=f"{name} leaf {i}")
            assert (np.abs(g - w) <= np.abs(o - w) + LEAF_ATOL).all(), (name, i)
    for r, res in enumerate(ranks[name][1:], 1):
        assert res["metrics"] == got["metrics"], (name, r)
        assert res["collectives"] == got["collectives"], (name, r)
        for a, b in zip(res["leaves"], got["leaves"]):
            np.testing.assert_array_equal(a, b, f"{name} rank {r}")
    return got, jw, one


# -- (a) dp 2 × ep 2 × tp 2: the whole batch's dispatch ------------------------------

def test_a_dp2_ep2_tp2_matches_jax_and_its_mesh(runs):
    """`trainable_full` (dense experts over ep and tp, the router whole),
    SGD 1e-2, 3 steps, ``moe_aux_weight`` 0.01: the module docstring's
    bounds, and every loss rtol 1e-6 and leaf atol 1e-6 of JAX's one device
    and of JAX's own dp 2 × ep 2 × tp 2 mesh; an expert stack's local part
    is a quarter of it, the router whole."""
    want, _, cases = runs
    name = "a_dp2_ep2_tp2"
    got, jw, _ = _hold(runs, name)
    for w in (jw, want["a_mesh"]):
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], w["losses"],
                                   rtol=LOSS_RTOL)
        for g, x in zip(got["leaves"], w["leaves"]):
            np.testing.assert_allclose(g, x, atol=LEAF_ATOL)
    shapes = dict(zip(_trained_paths(cases[name][0], jt.trainable_full), got["local_shapes"]))
    assert shapes["['layers']['w1']"] == (2, 2, 64, 64)   # E/ep, F/tp
    assert shapes["['layers']['w2']"] == (2, 2, 64, 64)
    assert shapes["['layers']['router']"] == (2, 64, 4)   # whole


def test_a_slots_are_jax_whole_batch_slots(runs):
    """The first step's slots a layer on every rank are the integers of
    JAX's dispatch over the whole batch at the rank's dp row's tokens; JAX
    drops at least one (token, choice) a layer, and the first dp row's rows
    alone would give JAX other logits (so the whole batch's routing is what
    is held)."""
    want, ranks, _ = runs
    got = ranks["a_dp2_ep2_tp2"]
    t_local = 2 * 16
    for r, res in enumerate(got):
        row = r // 4  # dp row of rank r on (dp 2, ep 2, tp 2)
        assert len(res["slots"]) == CFG.num_layers
        for layer, ((slot, kept), (jslot, cap)) in enumerate(zip(res["slots"], want["a_slots"])):
            mine = jslot[row * t_local:(row + 1) * t_local]
            np.testing.assert_array_equal(slot, mine, f"rank {r} layer {layer}")
            np.testing.assert_array_equal(kept, mine < cap)
    for jslot, cap in want["a_slots"]:
        assert cap == 16 and (jslot == cap).sum() >= 1
    whole, alone = want["a_rows"]
    assert np.abs(whole - alone).max() > 1e-3


# -- (b) dp 4 × ep 2: the scheme of the whole batch, the load-balancing loss ------------

def test_b_dp4_ep2_router_gradient_matches_jax(runs):
    """``moe_aux_weight`` 1.0, SGD 1e-2, 16 tokens a dp row (at most
    `DENSE_TOKEN_CUTOFF`: alone, a row would take the dense scheme) in a
    batch of 64 (the dispatch scheme): the module docstring's bounds (the
    loss metric, its load-balancing term counted once over dp, rtol 1e-6
    of JAX's); the router's first-step gradient atol 1e-6 of the port's one
    device and within 1e-6 of JAX's beyond the one device's distance; the
    slots JAX's."""
    want, ranks, cases = runs
    name = "b_dp4_ep2"
    got, jw, one = _hold(runs, name)
    i = _trained_paths(cases[name][0], jt.trainable_full).index("['layers']['router']")
    g, o, w = got["grads"][i], one["grads"][i], jw["grads"][i]
    assert np.abs(w).max() > 1e-2  # the aux term's share of it
    np.testing.assert_allclose(g, o, atol=1e-6)
    assert (np.abs(g - w) <= np.abs(o - w) + 1e-6).all()
    for r, res in enumerate(ranks[name]):
        row = r // 2  # dp row of rank r on (dp 4, ep 2)
        for (slot, _), (jslot, _) in zip(res["slots"], want["b_slots"]):
            np.testing.assert_array_equal(slot, jslot[row * 16:(row + 1) * 16], f"rank {r}")
    # the mask count, the loss's parts and the gradients summed over dp
    assert got["collectives"]["all_reduce_sum_dp"] == 3
    # an all_gather over dp a layer of the forward and of its recomputation
    assert got["collectives"]["all_gather_dp"] == 2 * CFG.num_layers


# -- (c) int8 weight-only experts over ep 4 × tp 2; (d) LoRA over dense experts -----------

@pytest.mark.parametrize("name", ["c_int8_ep4_tp2", "d_lora_dp2_ep2"])
def test_quantized_and_lora_trees_match_jax(runs, name):
    """(c) An int8 group-32 weight-only tree (every linear, the experts
    included) on ep 4 × tp 2, `trainable_full` (router, norms, embedding,
    head), Adam 5e-3; (d) rank-4 LoRA on wq/wk/wv/wo over dense experts on
    dp 2 × ep 2, Adam 5e-3: the module docstring's bounds."""
    _hold(runs, name)


# -- (e) the gathered state file ------------------------------------------------------

def test_moe_state_file_loads_in_jax_and_resumes(runs):
    """(a)'s state saved by ``save_train_state`` (expert stacks gathered
    over tp and ep, rank 0 writing): JAX's ``load_train_state`` takes it,
    its leaves bit for bit the gathered ones, and its next step's loss is
    the sharded resumed step's (rtol 1e-6); on the mesh the state loaded
    back is bit-equal to the one saved and a resumed step bit-identical to
    going on without the file, on every rank."""
    want, ranks, cases = runs
    name = "a_dp2_ep2_tp2"
    case = cases[name][3]
    for r, res in enumerate(ranks[name]):
        save = res["save"]
        assert save["same_leaves"] and save["same_moments"] and save["step"] == STEPS, r
        assert save["resume_equal"], r
    got = ranks[name][0]
    jw = want[name]
    back = jt.load_train_state(case["path"], jw["init"](jw["trainable"]))
    assert int(back.step) == STEPS
    for a, b in zip(back.trainable, got["leaves"]):
        assert np.array_equal(np.asarray(a), b)
    _, jloss, _ = jw["step"](back, jw["frozen"], case["batches"][0])
    np.testing.assert_allclose(got["save"]["next_loss"], jloss, rtol=LOSS_RTOL)


def test_expert_leaf_layout_round_trip():
    """`shard_leaf` then `gather_leaf` over ep and tp give an expert stack
    back (w1's experts and FFN columns, w2's experts and FFN rows); the
    router and a dense model's w1 are whole over ep."""
    cfg = port_config(CFG)
    rng = np.random.default_rng(1)
    for name, shape in (("w1", (2, 4, 64, 128)), ("w2", (2, 4, 128, 64))):
        path = (DictKey("layers"), DictKey(name))
        whole = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

        class Gather(Mesh):  # every rank's part, as the all_gathers hand them over
            def all_gather(self, t, dim=-1, axis="tp"):
                if axis == "tp":  # the tp parts at this rank's ep place
                    lo = 2 * self.index("ep")
                    return torch.cat([shard_leaf(whole, path, cfg, Mesh(tp=2, ep=2, rank=r))
                                      for r in (lo, lo + 1)], dim=dim)
                return torch.cat([shard_leaf(whole, path, cfg, Mesh(ep=2, rank=e))
                                  for e in range(2)], dim=dim)

        part = shard_leaf(whole, path, cfg, Mesh(tp=2, ep=2, rank=3))
        assert part.shape[1] == 2 and part.numel() * 4 == whole.numel()
        assert torch.equal(shard_leaf(whole, path, cfg, Mesh(ep=2, rank=1)), whole[:, 2:])
        assert torch.equal(gather_leaf(part, path, cfg, Gather(tp=2, ep=2, rank=3)), whole)
    assert leaf_ep_axis((DictKey("layers"), DictKey("router")), cfg, 2) is None
    assert leaf_ep_axis((DictKey("layers"), DictKey("w1")), cfg, 2) == -3
    dense = port_config(CFG.replace(num_experts=0))
    assert leaf_ep_axis((DictKey("layers"), DictKey("w1")), dense, 2) is None
