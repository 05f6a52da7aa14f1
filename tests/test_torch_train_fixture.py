"""The port's fixture trainer (metalchat_tpu_torch/tools/train_fixture.py)
against the JAX package's tools/train_fixture.py, on the CPU.

The JAX tool is imported by path and only its functions are called: its
``main`` writes into the committed fixture. Tolerances:

* the corpus, the crops and the configs: equal (bytes and integers);
* the learning-rate schedule against optax's: within 1e-6 of the peak lr
  (optax computes in f32, where its warmup's ``(0 - lr) * (1 - t) + lr``
  cancels: 2e-8 of the peak measured; the port in f64);
* three AdamW steps at the 10m widths (batch 2, seq 32) from JAX's seeded
  init carried across: the first loss within 1e-6 relative (the same f32
  parameters; the arithmetic in another order), the others within 1e-4
  (the loss writes k and v into a bf16 cache, so an ulp apart may flip a
  bf16 rounding: tests/test_torch_train.py's docstring); the final leaves by
  the L1 distance of the port's from JAX's within 1% of the distance JAX's
  moved (test_torch_train's `assert_leaves_close`);
* the written fixture: JAX's loader reads the port's file bit for bit as the
  bf16 of the trained leaves, and ``config.json``, ``tokenizer.model``,
  ``eval_tokens.npy`` and ``train_meta.json`` equal, byte for byte, what
  JAX's ``save_fixture`` writes from the same values.
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from metalchat_tpu import train as jt
from metalchat_tpu.config import load_config as jload_config
from metalchat_tpu.io.loaders import load_params as jload_params
from metalchat_tpu.io.safetensors import SafetensorsDocument as JDocument
from metalchat_tpu.models.transformer import init_random_params as jinit
from metalchat_tpu_torch.config import load_config
from metalchat_tpu_torch.convert import params_from_numpy
from metalchat_tpu_torch.io.loaders import load_params
from metalchat_tpu_torch.io.safetensors import open_safetensors
from metalchat_tpu_torch.tools import train_fixture as tf
from metalchat_tpu_torch.train.step import partition, trainable_full
from test_torch_train import assert_leaves_close
from torch_port_util import jax_tree_to_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_train_fixture",
                                                  ROOT / "tools" / "train_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JTOOL = _jax_tool()


def test_corpus_equals_jax():
    assert tf.harvest_corpus(1, 1) == JTOOL.harvest_corpus(1, 1)


@pytest.mark.parametrize("size", ["10m", "50m"])
def test_config_equals_jax(size):
    got, want = tf.make_config(size), JTOOL.make_config(size)
    fields = {f.name for f in dataclasses.fields(want)} & {f.name for f in dataclasses.fields(got)}
    assert {"vocab_size", "hidden_size", "num_layers", "num_kv_heads", "rms_norm_eps"} <= fields
    for name in sorted(fields):
        assert getattr(got, name) == getattr(want, name), name
    assert tf.VOCAB == JTOOL.VOCAB and tf.BOS == JTOOL.BOS


def test_batches_equal_jax():
    data = np.random.default_rng(5).integers(0, 256, 10_000).astype(np.int32)
    got = tf.batches(data, 4, 64, 7, seed=3)
    np.testing.assert_array_equal(got, JTOOL.batches(data, 4, 64, 7, seed=3))
    assert got.shape == (7, 4, 65) and got.dtype == np.int32


@pytest.mark.parametrize("steps", [101, 150, 3000])
def test_schedule_equals_optax(steps):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=100, decay_steps=steps,
                                              end_value=lr * 0.1)
    got = tf.lr_schedule(lr, steps)
    for count in range(151):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=0, atol=1e-6 * lr)
    assert got(0) == 0.0


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=100, decay_steps=20)
    with pytest.raises(ValueError, match="steps > 100"):
        tf.lr_schedule(3e-4, 20)


BATCH, SEQ, STEPS, LR, SCHEDULE = 2, 32, 3, 3e-2, 3000


@pytest.fixture(scope="module")
def trained():
    """Three steps of each side from JAX's init on the same crops: (the
    trainable leaves before, JAX's losses, JAX's leaves after, the port's
    trained tree, its losses)."""
    jcfg = JTOOL.make_config("10m")
    data = JTOOL.batches(np.random.default_rng(0).integers(0, 256, 50_000).astype(np.int32),
                         BATCH, SEQ, STEPS)
    jp = jinit(jcfg, seed=0, dtype=jnp.float32, max_seq_len=SEQ)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=100,
                                               decay_steps=SCHEDULE, end_value=LR * 0.1)
    opt = optax.adamw(sched, b1=0.9, b2=0.95, weight_decay=0.01)
    trainable, frozen, spec = jt.partition(jp, jt.trainable_full)
    init_state, step_fn = jt.make_train_step(jcfg, opt, spec, remat=False)
    state = init_state(trainable)
    jlosses = []
    for toks in data:
        toks = jnp.asarray(toks)
        state, m = step_fn(state, frozen, {"tokens": toks,
                                           "loss_mask": jnp.ones_like(toks[:, 1:], jnp.float32)})
        jlosses.append(float(m["loss"]))
    jleaves = [np.asarray(x) for x in state.trainable]
    start = [np.asarray(x) for x in trainable]
    params = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    logs = []
    tree, losses = tf.train_steps(params, tf.make_config("10m"), data, lr=LR, steps=SCHEDULE,
                                  chunk=2, log=logs.append)
    assert len(logs) == 2  # one host read a chunk of 2 steps
    return start, jlosses, jleaves, tree, losses


def test_three_steps_match_jax(trained):
    start, jlosses, jleaves, tree, losses = trained
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-6)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = [t.numpy() for t in partition(tree, trainable_full)[0]]
    assert len(got) == len(jleaves)
    assert_leaves_close(got, jleaves, start)
    moved = sum(float(np.abs(w - s).sum()) for w, s in zip(jleaves, start))
    assert moved > 0  # the schedule's second and third steps moved the leaves


def test_written_fixture_equals_jax(trained, tmp_path):
    *_, tree, losses = trained
    eval_data = np.random.default_rng(1).integers(0, 256, 4096).astype(np.int32)
    args = types.SimpleNamespace(steps=SCHEDULE, batch=BATCH, seq=SEQ, lr=LR)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    tf.save_fixture(tree, tf.make_config("10m"), eval_data, losses,
                    types.SimpleNamespace(out=str(ours), **vars(args)))
    jtree = jax.tree.map(jnp.asarray, jax_tree_to_numpy_from_port(tree))
    JTOOL.save_fixture(jtree, JTOOL.make_config("10m"), eval_data, losses,
                       types.SimpleNamespace(out=str(theirs), **vars(args)))
    for name in ("config.json", "tokenizer.model", "eval_tokens.npy", "train_meta.json"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    # The weights: JAX's loader reads the port's file as JAX's own.
    jcfg = jload_config(ours / "config.json")
    got = jax_tree_to_numpy(jload_params(JDocument.open(ours / "model.safetensors"), jcfg,
                                         dtype=jnp.float32, max_seq_len=SEQ))
    want = jax_tree_to_numpy(jload_params(JDocument.open(theirs / "model.safetensors"), jcfg,
                                          dtype=jnp.float32, max_seq_len=SEQ))
    for name, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name], w)
        np.testing.assert_array_equal(
            got["layers"][name], tree["layers"][name].to(torch.bfloat16).float().numpy())
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[name], want[name])
    # And the port reads it back through its native mapping.
    back = load_params(open_safetensors(ours), load_config(ours / "config.json"),
                       dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(back["embed"].numpy(), want["embed"])


def jax_tree_to_numpy_from_port(tree):
    """The port's dense tree as nested numpy dicts, the rope left out (the
    JAX tool's writer skips nothing, but its `save_params` reads no rope)."""
    out = {k: v.numpy() for k, v in tree.items() if k not in ("layers", "rope")}
    out["layers"] = {k: v.numpy() for k, v in tree["layers"].items()}
    return out


def test_out_has_no_default_and_the_card_is_the_default():
    with pytest.raises(SystemExit):
        tf.parse_args([])
    args = tf.parse_args(["--out", "x"])
    assert args.device == "cuda" and args.remat is False and args.steps == 3000
    assert tf.parse_args(["--out", "x", "--size", "50m"]).remat is True
