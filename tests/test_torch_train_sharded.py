"""The port's sharded train step (``make_train_step(..., mesh=)`` over dp and
tp) and its layer route with kv-heads that tp does not divide, against the
JAX package on the CPU.

Two launches of rank processes (tests/torch_train_worker.py, which imports
torch, numpy and the port only), one after the other, run over gloo through
a ``file://`` store while the JAX side of their cases runs here: eight
ranks make JAX's own test's mesh (dp 2 × tp 4: `CFG`'s two kv-heads stay
whole, one query head a rank) and tp 4 alone on each half; four ranks make
dp 2 × tp 2 and tp 2 alone on each pair. Each launch runs all its cases;
the two share one time limit (`RANK_TIMEOUT_S`). The batch is the global one on every rank, and each dp
row trains on its own rows of it, so dp is really used (JAX's own
``test_sharded_train_step_matches_single_device`` builds ``dp_batch`` and
never passes it, tests/test_train.py:177-181).

Tolerances, each stated where it is used:

* the first step on the same parameters (`CFG`, f32): loss rtol 1e-6,
  ``grad_norm`` rtol 1e-5, gradients atol 1e-5, as the one-device port
  meets them (tests/test_torch_train.py); every later loss rtol 1e-4 (the
  loss rounds k and v to a bf16 cache, and an f32 sum in another order may
  land on the other side of a bf16 rounding: tests/test_torch_train.py's
  docstring);
* against the port's own one-device step on the same inputs: every leaf
  atol 1e-6 after 3 SGD steps (only the order of f32 sums differs: the
  rank's products and the sums over tp and dp; measured 2.6e-8); after 3
  AdamW steps every element within 1e-4 (a tenth of the lr) and the L1
  distance within 1e-3 of the distance the leaves moved: Adam divides each
  element's step by its own gradient's root mean square, so an element
  whose gradient is near the f32 noise of the sums moves by a sizeable
  share of the lr whatever its exact value (measured: 2437 of the
  elements more than 1e-6 apart, at most 3.4e-5, L1 6.7e-5 of the
  movement);
* leaves against JAX's after several Adam steps by
  `test_torch_train.assert_leaves_close` (the L1 distance within 1% of
  the distance JAX's leaves moved);
* the first step's gradients on QLoRA and GPT-2 trees, whose adaptors and
  values are larger: the cache's bf16 rounding of k and v also rounds their
  gradients to bf16, so an f32 sum in another order can move a gradient
  element by one bf16 step (2^-9 of it). The port's one-device gradients
  stand that far from JAX's on these trees (QLoRA: 2.7e-4 at most, on
  wv's b; GPT-2: 1e-3 relative L2 on some leaves), so QLoRA's are held to
  atol 1e-5 plus 2^-9 of the leaf's largest gradient and GPT-2's to 2e-3
  relative L2 (its key bias, whose exact gradient is 0 since the softmax
  cancels it, to a norm under 1e-3 on both sides);
* a W8A8 LoRA tree and a Gemma-3 tree at tp 2 (its one kv-head whole, q/k
  norms): bf16 rounding flips in the cache spread through later layers
  and steps. With the cache in f32 the sharded gradients stand 1.1e-6
  (W8A8) and 1.7e-6 (Gemma) relative L2 from the one-device port's (a
  check made while writing this test); with the loss's bf16 cache 2.9e-3
  and 2.6e-3 from JAX's, where the one-device port stands up to 1e-3 on
  Gemma. So: the first loss rtol 1e-5, every loss rtol 1e-3 (a flip at
  step 2 moves Gemma's third SGD loss by 2.6e-4), the first ``grad_norm``
  rtol 1e-3, each leaf's gradient within 5e-3 relative L2;
* the layer route with whole kv-heads: f32 logits rtol/atol 2e-5 of JAX's
  ``forward(fast_decode=False)`` on its sharded mesh (tests/test_parallel.py's
  tolerance);
* metrics, the gathered leaves and the collectives: equal on every rank;
  a file saved from a sharded state: the JAX package loads it bit for bit,
  and a sharded resume from it is bit-identical to going on without it.
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
from metalchat_tpu.config import Gemma3Config as JGemma3Config
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import MixtralConfig as JMixtralConfig
from metalchat_tpu.models import forward as jforward
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.parallel import mesh as jmesh
from metalchat_tpu.quant.quantize import LoraLinear as JLoraLinear
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch import train as tt
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.models.transformer import forward
from metalchat_tpu_torch.parallel import (
    Mesh,
    gather_leaf,
    layer_route_refusal,
    leaf_tp_axis,
    rank_kv_heads,
    shard_leaf,
    shard_params,
    supports_tp_fast_decode,
)
from metalchat_tpu_torch.parallel.tp_decode import _local_config
from metalchat_tpu_torch.train.tree import tree_flatten_with_path
from torch_port_util import jax_tree_to_numpy, port_config

import torch_train_worker as worker
from test_torch_tp import _gpt2_tree, GPT2_CFG
from test_torch_train import assert_leaves_close

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 150
CPU = torch.device("cpu")
# tests/test_train.py's CFG: 4 heads over 2 kv-heads of 16.
CFG = JLlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                   max_seq_len=32, tie_word_embeddings=False)
# QLoRA's: CFG widened so that tp 2 leaves whole groups of 32 on every rank
# (an int4 rank's half-split packing needs 64 of wo's and w2's in-features).
QCFG = CFG.replace(hidden_size=128, intermediate_size=256, head_dim=32)
# The layer route's: CFG with 256 positions (row 6's block rule at one token)
# at tp 4, and a Gemma-3 of 4 heads over one kv-head at tp 2 (Gemma-3-1B's
# grouping), its sliding windows, two rope tables, q/k and post norms.
CFG_256 = CFG.replace(max_seq_len=256)
GEMMA = JGemma3Config.gemma3_1b(vocab_size=512, hidden_size=128, intermediate_size=256,
                                num_layers=3, num_heads=4, num_kv_heads=1, head_dim=64,
                                sliding_window=8, sliding_window_pattern=3, max_seq_len=256,
                                embedding_scale=128.0 ** 0.5)
PROMPT_LEN, STEPS = 40, 4
SGD = (lambda: optax.sgd(1e-2), "sgd")
ADAMW = (lambda: optax.adamw(1e-3), "adamw")
ADAM = (lambda: optax.adam(5e-3), "adam")
LEAF_TOL = dict(rtol=2e-5, atol=2e-5)


def make_batch(seed, b=4, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": np.ones((b, s - 1), np.float32)}


def _cfg_entry(jcfg):
    cfg = port_config(jcfg)
    return type(cfg).__name__, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _qlora_tree(seed, **quant):
    """Quantized bases (``quant``: int8 or int4 group 32, or W8A8 per
    channel) with rank-4 adaptors on every projection, ``b`` non-zero so
    that the first step's ``a`` gradients count."""
    jp = jt.attach_lora(jquantize_params(jinit(QCFG, seed=seed, dtype=jnp.float32), **quant),
                        rank=4, seed=seed)
    rng = np.random.default_rng(seed)
    layers = {k: dataclasses.replace(v, b=jnp.asarray(
        rng.standard_normal(v.b.shape) * 0.02, jnp.float32))
        if isinstance(v, JLoraLinear) else v for k, v in jp["layers"].items()}
    return dict(jp, layers=layers)


def _train_cases(tmp):
    """{world: {case: (JAX tree, JAX config, JAX optimizer, the worker's case)}}."""
    full = jinit(CFG, seed=6, dtype=jnp.float32)
    full_batches = [make_batch(6)] * 3
    gpt2 = _gpt2_tree(2)
    out = {8: {}, 4: {}}

    def case(world, name, jp, jcfg, opt, pred, batches, mesh, **extra):
        out[world][name] = (jp, jcfg, opt[0], dict(
            kind="train", cfg=_cfg_entry(jcfg), tree=jax_tree_to_numpy(jp), opt=opt[1],
            pred=pred, batches=batches, mesh=mesh, **extra))

    case(8, "full_sgd", full, CFG, SGD, "full", full_batches, "dp")
    case(8, "full_adamw", full, CFG, ADAMW, "full", full_batches, "dp",
         path=str(tmp / "sharded_state.safetensors"))
    for bits in (8, 4):
        jp = _qlora_tree(20 + bits, bits=bits, group_size=32)
        batches = [make_batch(bits, b=4)] * 3
        case(4, f"qlora{bits}_dp", jp, QCFG, ADAM, "lora", batches, "dp")
        case(4, f"qlora{bits}_tp", jp, QCFG, ADAM, "lora", batches, "tp")
    case(4, "w8a8_tp", _qlora_tree(40, bits=8, group_size=None, act_bits=8), QCFG, ADAM,
         "lora", [make_batch(40, b=2)] * 3, "tp")
    case(4, "gpt2_tp", gpt2, GPT2_CFG, SGD, "full",
         [make_batch(9, b=2, vocab=GPT2_CFG.vocab_size)] * 3, "tp")
    case(4, "gemma_tp", jinit(GEMMA, seed=41, dtype=jnp.float32), GEMMA, SGD, "full",
         [make_batch(41, b=2, vocab=GEMMA.vocab_size)] * 3, "tp")
    return out


def _windows(jcfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, jcfg.vocab_size, (1, PROMPT_LEN)).tolist()] + \
        [rng.integers(0, jcfg.vocab_size, (1, 1)).tolist() for _ in range(STEPS)]


def _inference_cases():
    """{world: {case: (JAX tree, JAX config, tp, the worker's case)}}."""
    out = {}
    for world, name, jcfg, tp, seed in ((8, "cfg_tp4", CFG_256, 4, 30),
                                        (4, "gemma_tp2", GEMMA, 2, 31)):
        jp = jinit(jcfg, seed=seed, dtype=jnp.float32)
        out.setdefault(world, {})[name] = (jp, jcfg, tp, dict(
            kind="forward", cfg=_cfg_entry(jcfg), tree=jax_tree_to_numpy(jp),
            windows=_windows(jcfg, seed), mesh="tp"))
    return out


@functools.partial(jax.jit, static_argnames=("jcfg", "spec"))
def _jax_loss_and_grads(trainable, frozen, batch, jcfg, spec):
    """The loss and gradients of JAX's ``make_train_step`` (its
    ``jax.value_and_grad`` of ``causal_lm_loss``), one compile a tree and
    config for every optimizer."""
    return jax.value_and_grad(lambda tr: jt.causal_lm_loss(
        jt.combine(tr, frozen, spec), batch["tokens"], batch["loss_mask"], jcfg))(trainable)


def _jax_step(jcfg, opt, spec, state, frozen, batch):
    """JAX's ``step_fn`` on one device (optax's update on the gradients):
    the next state, the loss, the gradients."""
    loss, grads = _jax_loss_and_grads(state.trainable, frozen,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jcfg=jcfg, spec=spec)
    updates, opt_state = opt.update(grads, state.opt_state, state.trainable)
    return jt.TrainState(optax.apply_updates(state.trainable, updates), opt_state,
                         state.step + 1), float(loss), grads


def _jax_train(jp, jcfg, opt, pred, batches):
    """JAX's one device: every step's loss and grad_norm, the first step's
    gradients, the final leaves, and what a resumed step needs."""
    t, f, spec = jt.partition(jp, pred)
    opt = opt()
    init, _ = jt.make_train_step(jcfg, opt, spec)
    state, losses, norms, first = init(t), [], [], None
    for batch in batches:
        state, loss, grads = _jax_step(jcfg, opt, spec, state, f, batch)
        first = grads if first is None else first
        losses.append(loss)
        norms.append(float(optax.global_norm(grads)))
    return {"losses": losses, "norms": norms, "grads": [np.asarray(g) for g in first],
            "leaves": [np.asarray(x) for x in state.trainable], "init": init,
            "step": functools.partial(_jax_step, jcfg, opt, spec), "frozen": f,
            "trainable": t}


def _jax_forward(jp, jcfg, tp, windows):
    """JAX's ``forward(fast_decode=False)`` on its tp mesh (GSPMD on
    ``shard_params``' placement): every window's logits."""
    mesh = jmesh.make_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    fwd = jax.jit(jforward, static_argnames=("config", "fast_decode"))
    params = jmesh.shard_params(jp, jcfg, mesh)
    cache = jmesh.shard_cache(JKVCache.create(jcfg, 1, jcfg.max_seq_len, dtype=jnp.float32),
                              mesh)
    out, pos = [], 0
    for tokens in windows:
        logits, cache = fwd(params, cache, jnp.asarray(tokens, jnp.int32), pos, config=jcfg,
                            fast_decode=False)
        out.append(np.asarray(logits))
        pos += len(tokens[0])
    return out


def _launch(world, tmp, inputs):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_DYNAMIC="FALSE", OMP_DYNAMIC="FALSE")
    return [subprocess.Popen(
        [sys.executable, str(HERE / "torch_train_worker.py"), str(r), str(world),
         str(tmp / f"store{world}"), str(inputs), str(tmp / f"w{world}_rank{r}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX results, {world: the ranks' results}, the cases)."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    train, infer = _train_cases(tmp), _inference_cases()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({w: {**{n: c[3] for n, c in train[w].items()},
                         **{n: c[3] for n, c in infer.get(w, {}).items()}}
                     for w in (8, 4)}, f)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    procs, logs, want, done = {}, {}, {}, {}
    try:  # one launch at a time (the suite's workers share the cores), each
        # while the JAX side of its cases runs
        for w in (8, 4):
            procs[w] = _launch(w, tmp, tmp / "inputs.pkl")
            for name, (jp, jcfg, opt, case) in train[w].items():
                pred = jt.trainable_full if case["pred"] == "full" else jt.trainable_lora
                key = (id(jp), case["opt"])  # dp and tp cases train one tree alike
                if key not in done:
                    done[key] = _jax_train(jp, jcfg, opt, pred, case["batches"])
                want[name] = done[key]
            for name, (jp, jcfg, tp, case) in infer[w].items():
                want[name] = _jax_forward(jp, jcfg, tp, case["windows"])
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
        ranks[w] = []
        for r in range(w):
            with open(tmp / f"w{w}_rank{r}.pkl", "rb") as f:
                ranks[w].append(pickle.load(f))
    return want, ranks, {**{n: c for w in train for n, c in train[w].items()},
                         **{n: c for w in infer for n, c in infer[w].items()}}


def _world(name):
    return 8 if name in ("full_sgd", "full_adamw", "cfg_tp4") else 4


def _port_one_device(jp, jcfg, opt_name, pred, batches):
    """The port's own one-device steps on the same inputs: (losses, norms,
    final leaves)."""
    t, f, spec = tt.partition(params_from_numpy(jax_tree_to_numpy(jp), CPU), pred)
    init, step = tt.make_train_step(port_config(jcfg), worker.OPTIMIZERS[opt_name], spec)
    state, losses = init(t), []
    for batch in batches:
        state, m = step(state, f, batch)
        losses.append(float(m["loss"]))
    return losses, [x.detach().numpy() for x in state.trainable], state


def _same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for r, res in enumerate(ranks[1:], 1):
        assert res[name]["metrics"] == first["metrics"], (name, r)
        assert res[name]["collectives"] == first["collectives"], (name, r)
        for a, b in zip(res[name]["leaves"], first["leaves"]):
            np.testing.assert_array_equal(a, b, f"{name} rank {r}")


# -- JAX's own test, with dp used --------------------------------------------------

def test_full_sgd_dp2_tp4_matches_jax_and_one_device(runs):
    """`trainable_full`, f32, SGD 1e-2 for 3 steps on dp 2 × tp 4 (`CFG`'s
    kv-heads whole): the first step's loss rtol 1e-6, ``grad_norm`` rtol
    1e-5 and gradients atol 1e-5 against JAX's one device, every loss rtol
    1e-4; every leaf atol 1e-6 of the port's one-device step after the 3
    steps; metrics and leaves equal on all 8 ranks; the collectives of a
    step (the batch's rows split: each rank's local batch is 2 rows)."""
    want, ranks, cases = runs
    jp, jcfg, _, case = cases["full_sgd"]
    got = ranks[8][0]["full_sgd"]
    losses = [m["loss"] for m in got["metrics"]]
    np.testing.assert_allclose(losses[0], want["full_sgd"]["losses"][0], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want["full_sgd"]["norms"][0],
                               rtol=1e-5)
    assert len(got["grads"]) == len(want["full_sgd"]["grads"])
    for g, w in zip(got["grads"], want["full_sgd"]["grads"]):
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_allclose(losses, want["full_sgd"]["losses"], rtol=1e-4)
    assert [m["step"] for m in got["metrics"]] == [1, 2, 3]
    one_losses, one_leaves, _ = _port_one_device(jp, jcfg, "sgd", tt.trainable_full,
                                                 case["batches"])
    for g, w in zip(got["leaves"], one_leaves):
        np.testing.assert_allclose(g, w, atol=1e-6)
    _same_on_every_rank(ranks[8], "full_sgd")
    # tp 4 over 4 heads: one query head a rank, wk and wv whole
    paths = [p for p, f in zip(*_paths_and_flags(jp)) if f]
    shapes = dict(zip(paths, got["local_shapes"]))
    assert shapes["['layers']['wq']"] == (2, 64, 16) and shapes["['layers']['wk']"] == (2, 64, 32)
    # the first step: the mask count, the gradients and the loss summed over
    # dp; the logits gathered over tp; in the backward pass the whole inputs
    # of the column-parallel products (attention's and the FFN's a layer,
    # the head's) and the whole k and v a layer summed over tp
    c = got["collectives"]
    assert c["all_reduce_sum_dp"] == 3 and c["all_gather"] == 1, c
    assert c["all_reduce_sum_backward"] == 4 * CFG.num_layers + 1, c


def _paths_and_flags(jp):
    """The port's tree's leaf paths (as ``keystr`` prints them) and their
    `trainable_full` flags."""
    tree = params_from_numpy(jax_tree_to_numpy(jp), CPU)
    paths = [''.join(map(str, p)) for p, _ in tree_flatten_with_path(tree)[0]]
    return paths, tt.partition(tree, tt.trainable_full)[2][1]


def test_full_adamw_dp2_tp4(runs):
    """AdamW 1e-3 (weight decay 1e-4, optax's) for 3 steps: losses rtol 1e-4
    of JAX's, leaves by `assert_leaves_close`; against the port's own one
    device every element within 1e-4 and the L1 distance within 1e-3 of
    the movement (the module docstring), and the moments gathered in
    optax's layout (count 3, then every first and second moment) within
    1e-5 of its moments."""
    want, ranks, cases = runs
    jp, jcfg, _, case = cases["full_adamw"]
    got = ranks[8][0]["full_adamw"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               want["full_adamw"]["losses"], rtol=1e-4)
    start = [np.asarray(x) for x in jt.partition(jp, jt.trainable_full)[0]]
    assert_leaves_close(got["leaves"], want["full_adamw"]["leaves"], start)
    _, one_leaves, state = _port_one_device(jp, jcfg, "adamw", tt.trainable_full,
                                            case["batches"])
    for g, w in zip(got["leaves"], one_leaves):
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert_leaves_close(got["leaves"], one_leaves, start, share=1e-3)
    from metalchat_tpu_torch.convert import optimizer_state_leaves

    moments = optimizer_state_leaves(state.opt_state, state.trainable)
    assert len(got["moments"]) == len(moments) == 2 * len(one_leaves) + 1
    assert int(got["moments"][0]) == 3
    for g, w in zip(got["moments"][1:], moments[1:]):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5)
    _same_on_every_rank(ranks[8], "full_adamw")


def test_sharded_state_file_loads_in_jax_and_resumes(runs, tmp_path):
    """The dp 2 × tp 4 AdamW state saved by ``save_train_state`` (gathered,
    rank 0 writing): JAX's ``load_train_state`` takes it, its leaves and
    moments bit for bit the gathered state's; the port's one-device template
    loads it bit for bit too and its next step gives JAX's next loss (rtol
    1e-5) and leaves (atol 5e-5, 1% of Adam's... AdamW's lr 1e-3 times 5%:
    the noise-floor elements of the module docstring); on the mesh, the
    state loaded back is bit-equal to the one saved, and a resumed step is
    bit-identical to going on without the file, on every rank."""
    want, ranks, cases = runs
    jp, jcfg, _, case = cases["full_adamw"]
    for r, res in enumerate(ranks[8]):
        save = res["full_adamw"]["save"]
        assert save["same_leaves"] and save["same_moments"] and save["step"] == 3, r
        assert save["resume_equal"], r
    got = ranks[8][0]["full_adamw"]
    jw = want["full_adamw"]
    back = jt.load_train_state(case["path"], jw["init"](jw["trainable"]))
    assert int(back.step) == 3
    for a, b in zip(back.trainable, got["leaves"]):
        assert np.array_equal(np.asarray(a), b)
    jmoments = jax.tree_util.tree_leaves(back.opt_state)
    assert len(jmoments) == len(got["moments"])
    for a, b in zip(jmoments, got["moments"]):
        assert np.array_equal(np.asarray(a).reshape(np.shape(b)), b)
    jnext, jloss, _ = jw["step"](back, jw["frozen"], case["batches"][0])
    t, f, spec = tt.partition(params_from_numpy(jax_tree_to_numpy(jp), CPU),
                              tt.trainable_full)
    init, step = tt.make_train_step(port_config(jcfg), worker.OPTIMIZERS["adamw"], spec)
    restored = tt.load_train_state(case["path"], init(t))
    for a, b in zip(restored.trainable, got["leaves"]):
        assert np.array_equal(a.detach().numpy(), b)
    tnext, tm = step(restored, f, case["batches"][0])
    np.testing.assert_allclose(float(tm["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), got["save"]["next_loss"], rtol=1e-5)
    for a, b in zip(tnext.trainable, jnext.trainable):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=5e-5)


# -- QLoRA and a biased tree --------------------------------------------------------

@pytest.mark.parametrize("name", ["qlora8_dp", "qlora4_dp", "qlora8_tp", "qlora4_tp"])
def test_qlora_sharded_matches_jax(runs, name):
    """LoRA rank 4 over int8 and int4 group-32 bases (`QCFG`), Adam 5e-3 for
    3 steps, at dp 2 × tp 2 and at tp 2: the first loss rtol 1e-6 and every
    loss rtol 1e-4 of JAX's one device, the first step's adaptor gradients
    atol 1e-5 plus one bf16 step (the module docstring), ``grad_norm`` rtol
    1e-5, the adaptors by
    `assert_leaves_close`; metrics and adaptors equal on every rank."""
    want, ranks, cases = runs
    jp = cases[name][0]
    got = ranks[4][0][name]
    losses = [m["loss"] for m in got["metrics"]]
    np.testing.assert_allclose(losses[0], want[name]["losses"][0], rtol=1e-6)
    np.testing.assert_allclose(losses, want[name]["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want[name]["norms"][0],
                               rtol=1e-5)
    assert len(got["grads"]) == len(want[name]["grads"]) == 14
    for g, w in zip(got["grads"], want[name]["grads"]):
        np.testing.assert_allclose(g, w, atol=1e-5 + 2 ** -9 * np.abs(w).max())
    start = [np.asarray(x) for x in jt.partition(jp, jt.trainable_lora)[0]]
    assert_leaves_close(got["leaves"], want[name]["leaves"], start)
    group = ranks[4] if name.endswith("_dp") else ranks[4][:2]
    _same_on_every_rank(group, name)


@pytest.mark.parametrize("name", ["w8a8_tp", "gemma_tp"])
def test_act8_lora_and_gemma_tp2_match_jax(runs, name):
    """At tp 2: LoRA rank 4 over W8A8 per-channel bases (the row-parallel
    act8 absmax's gradient to the rank that holds it), Adam 5e-3, and a
    Gemma-3 tree trained whole (`trainable_full`, SGD 1e-2; its one
    kv-head whole on both ranks, q/k norms, post norms, tied head), 3 steps:
    the module docstring's tolerances against JAX's one device; metrics and
    leaves equal on both ranks."""
    want, ranks, _ = runs
    got = ranks[4][0][name]
    losses = [m["loss"] for m in got["metrics"]]
    np.testing.assert_allclose(losses[0], want[name]["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, want[name]["losses"], rtol=1e-3)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want[name]["norms"][0],
                               rtol=1e-3)
    assert len(got["grads"]) == len(want[name]["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want[name]["grads"])):
        assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w), (name, i)
    _same_on_every_rank(ranks[4][:2], name)


def test_biased_tree_tp2_matches_jax(runs):
    """A GPT-2 tree (non-zero norm and projection biases, learned positions,
    an odd vocabulary: the embedding and the tied head whole on every rank)
    at tp 2, `trainable_full`, SGD 1e-2 for 3 steps: the first step's loss
    rtol 1e-6 and ``grad_norm`` rtol 1e-4, its gradients within 2e-3
    relative L2 leaf by leaf (the module docstring), every loss rtol 1e-4
    of JAX's."""
    want, ranks, cases = runs
    got = ranks[4][0]["gpt2_tp"]
    losses = [m["loss"] for m in got["metrics"]]
    np.testing.assert_allclose(losses[0], want["gpt2_tp"]["losses"][0], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], want["gpt2_tp"]["norms"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(losses, want["gpt2_tp"]["losses"], rtol=1e-4)
    paths = [p for p, f in zip(*_paths_and_flags(cases["gpt2_tp"][0])) if f]
    assert len(paths) == len(got["grads"]) == len(want["gpt2_tp"]["grads"])
    for path, g, w in zip(paths, got["grads"], want["gpt2_tp"]["grads"]):
        if path == "['layers']['wk_b']":
            assert np.linalg.norm(g) < 1e-3 and np.linalg.norm(w) < 1e-3
        else:
            assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w), path
    _same_on_every_rank(ranks[4][:2], "gpt2_tp")


# -- the layer route with kv-heads that tp does not divide ---------------------------

@pytest.mark.parametrize("name", ["cfg_tp4", "gemma_tp2"])
def test_layer_route_whole_kv_heads_matches_jax(runs, name):
    """``forward(..., tp=mesh)`` with kv-heads whole on every rank: `CFG`'s
    2 kv-heads at tp 4 (one query head a rank) and a Gemma-3 of 4 heads over
    one kv-head at tp 2 (two a rank, its windows, rope tables and norms): a
    40-token prompt (flash's plain version), then 4 one-token steps (row 6's
    on the 256-position cache), within 2e-5 of JAX's sharded forward; the
    route `spmd_forward_fn` picks is the layer route, the cache holds every
    kv-head, every rank the same logits."""
    want, ranks, cases = runs
    jcfg = cases[name][1]
    world = _world(name)
    for r, res in enumerate(ranks[world]):
        got = res[name]
        assert got["route"] == "layer_route_forward_fn" and \
            got["cache_heads"] == jcfg.num_kv_heads, (r, got["route"])
        for i, (g, w) in enumerate(zip(got["logits"], want[name])):
            np.testing.assert_allclose(g, w, **LEAF_TOL, err_msg=f"{name} rank {r} call {i}")
            np.testing.assert_array_equal(g, ranks[world][0][name]["logits"][i])


def test_rank_kv_heads_and_local_config():
    """Which kv-head each rank's query heads read, and the local config's
    kv-heads: whole where tp does not divide them."""
    cfg = port_config(CFG)
    assert [rank_kv_heads(cfg, Mesh(tp=4, rank=r)) for r in range(4)] == [
        (0,), (0,), (1,), (1,)]
    assert rank_kv_heads(cfg, Mesh(tp=2, rank=1)) is None
    gemma = port_config(GEMMA)
    assert [rank_kv_heads(gemma, Mesh(tp=2, rank=r)) for r in range(2)] == [(0, 0), (0, 0)]
    assert _local_config(cfg, 4).num_kv_heads == 2 and _local_config(cfg, 2).num_kv_heads == 1
    assert layer_route_refusal(cfg, Mesh(tp=4)) is None
    assert not supports_tp_fast_decode({"layers": {}}, cfg, Mesh(tp=4))


def test_leaf_layout_round_trip():
    """`shard_leaf` then `gather_leaf` over every rank gives the whole leaf
    back (a dense fused wqkv with whole kv-heads, w13 and its bias, LoRA
    ``a``/``b``, the embedding); `leaf_tp_axis` names the split."""
    from metalchat_tpu_torch.train.tree import DictKey, GetAttrKey

    cfg = port_config(CFG)
    rng = np.random.default_rng(0)
    cases = {("layers", "wqkv"): (2, 64, 128), ("layers", "w13"): (2, 64, 256),
             ("layers", "w13_b"): (2, 256), ("layers", "wo", "a"): (2, 64, 4),
             ("layers", "wq", "b"): (2, 4, 64), ("embed",): (128, 64)}
    for keys, shape in cases.items():
        path = tuple(DictKey(k) for k in keys[:2] if k not in ("a", "b")) + \
            tuple(GetAttrKey(k) for k in keys if k in ("a", "b"))
        whole = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

        class Gather(Mesh):  # every rank's part, as all_gather hands them over
            def all_gather(self, t, dim=-1, axis="tp"):
                return torch.cat([shard_leaf(whole, path, cfg, Mesh(tp=4, rank=r))
                                  for r in range(4)], dim=dim)

        part = shard_leaf(whole, path, cfg, Mesh(tp=4, rank=1))
        assert leaf_tp_axis(path, cfg, 4) is not None and part.numel() * 4 >= whole.numel()
        assert torch.equal(gather_leaf(part, path, cfg, Gather(tp=4, rank=1)), whole), keys
    assert leaf_tp_axis((DictKey("layers"), DictKey("wk")), cfg, 4) is None  # kv whole
    assert leaf_tp_axis((DictKey("layers"), DictKey("wq"), GetAttrKey("a")), cfg, 4) is None
    with pytest.raises(ValueError, match="quantized payload"):
        leaf_tp_axis((DictKey("layers"), DictKey("wq"), GetAttrKey("q")), cfg, 4)


# -- refusals --------------------------------------------------------------------

def test_refusals():
    """A `LoraLinear` on an MoE expert stack, which the JAX package's forward
    fails on (JAX's ``attach_lora`` wraps w1/w2/w3 with its default targets,
    and its ``_expert_linear`` calls ``astype`` on the leaf), is refused
    with a ``ValueError`` naming the leaf, in one-device ``forward`` and in
    ``make_train_step(mesh=)``; a batch whose rows dp does not divide is
    refused with the reason (before any collective)."""
    moe_cfg = JMixtralConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                             num_layers=1, num_heads=4, num_kv_heads=2, head_dim=8,
                             max_seq_len=32, tie_word_embeddings=False, num_experts=4,
                             num_experts_per_tok=2)
    tmoe = port_config(moe_cfg)
    jp = jt.attach_lora(jinit(moe_cfg, seed=0, dtype=jnp.float32), rank=4)
    assert isinstance(jp["layers"]["w1"], JLoraLinear)
    with pytest.raises(AttributeError, match="'LoraLinear' object has no attribute 'astype'"):
        jforward(jp, JKVCache.create(moe_cfg, 1, 8), jnp.zeros((1, 4), jnp.int32), 0, moe_cfg,
                 fast_decode=False)
    moe = params_from_numpy(jax_tree_to_numpy(jp), CPU)
    from metalchat_tpu_torch.cache import KVCache

    with pytest.raises(ValueError, match=r"\['layers'\]\['w1'\]: LoRA on an MoE expert stack"):
        forward(moe, KVCache.create(tmoe, 1, 8, device=CPU), torch.zeros((1, 4), dtype=torch.long),
                0, tmoe)
    t, f, spec = tt.partition(moe, tt.trainable_lora)
    with pytest.raises(ValueError, match=r"\['layers'\]\['w1'\]: LoRA on an MoE expert stack"):
        tt.make_train_step(tmoe, worker.OPTIMIZERS["sgd"], spec, mesh=Mesh(ep=2, rank=0))
    cfg = port_config(CFG)
    params = params_from_numpy(jax_tree_to_numpy(jinit(CFG, seed=0, dtype=jnp.float32)), CPU)
    t, f, spec = tt.partition(params, tt.trainable_full)
    init, step = tt.make_train_step(cfg, worker.OPTIMIZERS["sgd"], spec, mesh=Mesh(dp=2))
    with pytest.raises(ValueError, match="3 rows does not divide over dp=2"):
        step(init(t), f, make_batch(0, b=3))
