"""The port's training (metalchat_tpu_torch/train, forward's differentiable,
remat and aux route, MoE's load-balancing loss) against the JAX package,
on the CPU.

The configuration and sizes are tests/test_train.py's (hidden 64, 2 layers,
4 heads over 2 kv heads of 16, vocabulary 128, batches of 4 × 16 tokens).
Parameters come from the JAX package's seeded init and cross as numpy
bytes (`convert.params_from_numpy`); batches are numpy draws; LoRA's A
crosses from JAX too (the two random streams are not compared). Optimizers
take optax's values: Adam (0.9, 0.999, 1e-8), AdamW with optax's weight
decay 1e-4 (torch's default is 1e-2), SGD.

Tolerances, each stated where it is used:

* one loss or gradient on the same parameters: the f32 arithmetic in
  another order, loss rtol 1e-6 and gradients atol 1e-5;
* trajectories of several steps: the loss writes k and v into a bf16 cache
  and rounds the softmax weights to bf16 (the JAX package's XLA route), so
  an f32 value an ulp apart in the two packages can land on either side of
  a bf16 rounding boundary, a jump of 2^-9 relative in that value. Such
  flips start after a few steps; after them losses agree within 1e-4
  relative. Leaves are held in total (`assert_leaves_close`): the L1
  distance of the port's from JAX's within 1% of the L1 distance JAX's
  moved (measured 0.02-0.43%). Not element by element: Adam's first step is
  lr · g / (|g| + 1e-8), so an element whose gradient sits at the f32 noise
  floor (about 1e-8) moves by anything up to lr, in either direction, in
  either package (seen: a handful of 70k elements, 1.55 lr apart).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from metalchat_tpu import train as jt
from metalchat_tpu.cache import KVCache as JKVCache
from metalchat_tpu.config import LlamaConfig as JLlamaConfig
from metalchat_tpu.config import MixtralConfig as JMixtralConfig
from metalchat_tpu.models import init_random_params as jinit
from metalchat_tpu.models.moe import load_balancing_loss as jload_balancing_loss
from metalchat_tpu.models.transformer import forward as jforward
from metalchat_tpu.quant.quantize import LoraLinear as JLoraLinear
from metalchat_tpu.quant.quantize import quantize_params as jquantize_params
from metalchat_tpu_torch import train as tt
from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
from metalchat_tpu_torch.convert import params_from_numpy, set_optimizer_state
from metalchat_tpu_torch.models import moe as tmoe
from metalchat_tpu_torch.models import transformer as ttransformer
from metalchat_tpu_torch.ops import _build
from metalchat_tpu_torch.quant.quantize import LoraLinear
from metalchat_tpu_torch.train.tree import keystr, tree_flatten_with_path
from torch_port_util import jax_tree_to_numpy, port_config

torch.set_num_threads(2)

CFG = JLlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                   max_seq_len=32, tie_word_embeddings=False)
TCFG = port_config(CFG)
MOE_CFG = JMixtralConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10000.0,
                         max_seq_len=64, tie_word_embeddings=False, num_experts=4,
                         num_experts_per_tok=2)

# optax's optimizer and the torch factory with the same values.
OPTIMIZERS = {
    "adam": (lambda: optax.adam(5e-3), lambda ps: torch.optim.Adam(ps, lr=5e-3)),
    "adamw": (lambda: optax.adamw(1e-3),
              lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)),
    "sgd": (lambda: optax.sgd(1e-1), lambda ps: torch.optim.SGD(ps, lr=1e-1)),
}


def make_batch(seed=0, b=4, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": np.ones((b, s - 1), np.float32)}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(jparams):
    return params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")


def both(seed, cfg=CFG, quant=None, lora=None):
    """(JAX params, the port's params): JAX's seeded init in f32, optionally
    quantized by ``quant`` and LoRA-attached by ``lora`` (JAX's A), then
    carried across."""
    jp = jinit(cfg, seed=seed, dtype=jnp.float32)
    if quant is not None:
        jp = jquantize_params(jp, **quant)
    if lora is not None:
        jp = jt.attach_lora(jp, **lora)
    return jp, to_port(jp)


def run_jax(jp, opt, pred, batches, cfg=CFG, loss_fn=None):
    trainable, frozen, spec = jt.partition(jp, pred)
    init_state, step_fn = jt.make_train_step(cfg, opt, spec, loss_fn=loss_fn)
    state = init_state(trainable)
    losses = []
    for batch in batches:
        state, m = step_fn(state, frozen, jbatch(batch))
        losses.append(float(m["loss"]))
    return losses, [np.asarray(x) for x in state.trainable], state


def run_port(tp, opt, pred, batches, cfg=TCFG, loss_fn=None):
    trainable, frozen, spec = tt.partition(tp, pred)
    init_state, step_fn = tt.make_train_step(cfg, opt, spec, loss_fn=loss_fn)
    state = init_state(trainable)
    losses = []
    for batch in batches:
        state, m = step_fn(state, frozen, batch)
        losses.append(float(m["loss"]))
    return losses, [x.detach().numpy() for x in state.trainable], state


def assert_leaves_close(got, want, start, share=0.01):
    """Σ|got - want| ≤ share · Σ|want - start| over every leaf (module
    docstring)."""
    apart = sum(float(np.abs(g - w).sum()) for g, w in zip(got, want))
    moved = sum(float(np.abs(w - s).sum()) for w, s in zip(want, start))
    assert apart <= share * moved, (apart, moved)


# -- the loss and its gradients -------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_jax(remat):
    """f32 loss on the same parameters and batch: rtol 1e-6."""
    jp, tp = both(1)
    batch = make_batch(1)
    want = float(jt.causal_lm_loss(jp, *jbatch(batch).values(), CFG, remat=remat))
    got = tt.causal_lm_loss(tp, torch.from_numpy(batch["tokens"]),
                            torch.from_numpy(batch["loss_mask"]), TCFG, remat=remat)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert abs(want - np.log(CFG.vocab_size)) < 1.0


def _jax_grads(jp, batch, remat, pred=jt.trainable_full, cfg=CFG):
    t, f, spec = jt.partition(jp, pred)
    b = jbatch(batch)
    return jax.grad(lambda tr: jt.causal_lm_loss(jt.combine(tr, f, spec), b["tokens"],
                                                 b["loss_mask"], cfg, remat=remat))(t)


def _port_grads(tp, batch, remat, pred=tt.trainable_full, cfg=TCFG):
    t, f, spec = tt.partition(tp, pred)
    t = [x.detach().clone().requires_grad_(True) for x in t]
    loss = tt.causal_lm_loss(tt.combine(t, f, spec), torch.from_numpy(batch["tokens"]),
                             torch.from_numpy(batch["loss_mask"]), cfg, remat=remat)
    return [g.numpy() for g in torch.autograd.grad(loss, t)]


@pytest.mark.parametrize("remat", [False, True])
def test_full_gradients_match_jax(remat):
    """`trainable_full` gradients against JAX's: atol 1e-5."""
    jp, tp = both(1)
    batch = make_batch(1)
    want = _jax_grads(jp, batch, remat)
    got = _port_grads(tp, batch, remat)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_remat_matches_no_remat():
    """tests/test_train.py's remat check on the port: loss rtol 1e-6,
    gradients atol 1e-5."""
    _, tp = both(1)
    batch = make_batch(1)
    a, b = _port_grads(tp, batch, False), _port_grads(tp, batch, True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-5)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """8 steps of Adam, AdamW and SGD on one batch: the first step's loss
    and gradient norm rtol 1e-6 and 1e-5, every loss rtol 1e-4 (bf16 flips,
    module docstring), the final leaves by `assert_leaves_close`."""
    jp, tp = both(2)
    batches = [make_batch(2)] * 8
    j_opt, t_opt = OPTIMIZERS[name]
    jl, jleaves, _ = run_jax(jp, j_opt(), jt.trainable_full, batches)
    tl, tleaves, state = run_port(tp, t_opt, tt.trainable_full, batches)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] - 0.1
    assert int(state.step) == 8 and state.step.dtype == torch.int32
    start = [np.asarray(x) for x in jt.partition(jp, jt.trainable_full)[0]]
    assert_leaves_close(tleaves, jleaves, start)


def test_first_step_metrics_match_jax():
    """The step's metrics: loss rtol 1e-6, grad_norm rtol 1e-5, step 1."""
    jp, tp = both(3)
    batch = make_batch(3)
    t, f, spec = jt.partition(jp, jt.trainable_full)
    init, step = jt.make_train_step(CFG, optax.sgd(1e-2), spec)
    _, jm = step(init(t), f, jbatch(batch))
    t2, f2, spec2 = tt.partition(tp, tt.trainable_full)
    init2, step2 = tt.make_train_step(TCFG, lambda ps: torch.optim.SGD(ps, lr=1e-2), spec2)
    _, tm = step2(init2(t2), f2, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(tm["step"]) == int(jm["step"]) == 1


# -- partition, LoRA -----------------------------------------------------------

@pytest.mark.parametrize("quant", [None, dict(bits=8), dict(bits=4, group_size=None,
                                                            act_bits=8)], ids=str)
def test_partition_leaf_order_and_paths_match_jax(quant):
    """The flattened tree: the same leaf paths in the same order as
    ``jax.tree_util``, the same trainable flags under `trainable_lora` and
    `trainable_full`, and leaves equal; `combine` rebuilds the tree."""
    jp, tp = both(3, quant=quant, lora=dict(rank=4))
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    with_path, _ = tree_flatten_with_path(tp)
    assert [keystr(p) for p, _ in with_path] == jpaths
    for (_, leaf), (_, jleaf) in zip(with_path, jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    for jpred, tpred in ((jt.trainable_lora, tt.trainable_lora),
                         (jt.trainable_full, tt.trainable_full)):
        jtr, jfr, (_, jflags) = jt.partition(jp, jpred)
        ttr, tfr, spec = tt.partition(tp, tpred)
        assert spec[1] == jflags
        assert len(ttr) == len(jtr) and len(tfr) == len(jfr)
    ttr, tfr, spec = tt.partition(tp, tt.trainable_lora)
    assert len(ttr) == 14  # 7 targets × (a, b)
    assert tt.lora_param_count(tp) == sum(x.numel() for x in ttr) \
        == jt.lora_param_count(jp)
    rebuilt = tt.combine(ttr, tfr, spec)
    for name in ("wq", "w1"):
        assert isinstance(rebuilt["layers"][name], LoraLinear)
        assert rebuilt["layers"][name].a is tp["layers"][name].a


def test_attach_lora_shapes_and_generator():
    """A from an explicit generator (N(0, 1/rank)), B zero, the JAX shapes;
    the same seed gives the same A."""
    _, tp = both(3)
    a1 = tt.attach_lora(tp, rank=4, seed=5)
    a2 = tt.attach_lora(tp, rank=4, generator=torch.Generator().manual_seed(5))
    jshapes = jax.tree_util.tree_map(lambda x: x.shape, jt.attach_lora(
        jinit(CFG, seed=3, dtype=jnp.float32), rank=4))
    for name in tt.lora.DEFAULT_TARGETS:
        leaf = a1["layers"][name]
        assert leaf.a.shape == jshapes["layers"][name].a
        assert leaf.b.shape == jshapes["layers"][name].b
        assert leaf.a.dtype == torch.float32 and not leaf.b.any()
        assert torch.equal(leaf.a, a2["layers"][name].a)
    a = torch.cat([a1["layers"][n].a.flatten() for n in tt.lora.DEFAULT_TARGETS])
    assert abs(float(a.std()) * 4 ** 0.5 - 1.0) < 0.05


def test_qlora_over_int8_matches_jax_and_base_frozen():
    """LoRA over an int8 g32 base (JAX's `test_qlora_training_descends_and_
    base_frozen`): the first step's adaptor gradients atol 1e-5 against
    JAX's; 10 Adam steps, losses rtol 1e-3 (the bf16 flips of the module
    docstring, grown over two more steps than the other trajectories: 3.7e-4
    at the tenth), the loss descends, the base bytes unchanged, adaptors
    by `assert_leaves_close`."""
    lora = dict(rank=4, targets=("wq", "wv", "w1", "w2"))
    jp, tp = both(4, quant=dict(bits=8), lora=lora)
    trainable, frozen, _ = tt.partition(tp, tt.trainable_lora)
    before = [x.clone() for x in frozen]
    batches = [make_batch(4)] * 10
    want = _jax_grads(jp, batches[0], True, jt.trainable_lora)
    got = _port_grads(tp, batches[0], True, tt.trainable_lora)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    jl, jleaves, _ = run_jax(jp, optax.adam(5e-3), jt.trainable_lora, batches)
    tl, tleaves, _ = run_port(tp, lambda ps: torch.optim.Adam(ps, lr=5e-3),
                              tt.trainable_lora, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0] - 0.05
    assert any(isinstance(x, torch.Tensor) and x.dtype == torch.int8 for x in frozen)
    for b, a in zip(before, frozen):
        assert torch.equal(b, a)
    for name in lora["targets"]:  # the caller's tree is not trained in place
        assert not tp["layers"][name].b.any()
    assert_leaves_close(tleaves, jleaves, [x.numpy() for x in trainable])


def test_lora_zero_init_identity_and_merge():
    """B = 0: the adapted loss equals the base loss (rtol 1e-6); after 5
    steps `merge_lora` in f32 gives the tuned loss (rtol 1e-4, as JAX's
    test) and JAX's merged weights on the same adaptors (atol 1e-6)."""
    jbase, base = both(5)
    batch = make_batch(5)
    tok, mask = torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["loss_mask"])
    adapted = tt.attach_lora(base, rank=4)
    np.testing.assert_allclose(float(tt.causal_lm_loss(adapted, tok, mask, TCFG)),
                               float(tt.causal_lm_loss(base, tok, mask, TCFG)), rtol=1e-6)
    trainable, frozen, spec = tt.partition(adapted, tt.trainable_lora)
    init, step = tt.make_train_step(TCFG, lambda ps: torch.optim.Adam(ps, lr=5e-3), spec)
    state = init(trainable)
    for _ in range(5):
        state, _ = step(state, frozen, batch)
    tuned = tt.combine([x.detach() for x in state.trainable], frozen, spec)
    merged = tt.merge_lora(tuned, dtype=torch.float32)
    assert not any(isinstance(leaf, LoraLinear) for leaf in merged["layers"].values())
    np.testing.assert_allclose(float(tt.causal_lm_loss(merged, tok, mask, TCFG)),
                               float(tt.causal_lm_loss(tuned, tok, mask, TCFG)), rtol=1e-4)
    # JAX's merge of the same tuned adaptors
    jtuned = dict(jbase, layers=dict(jbase["layers"]))
    for name, leaf in tuned["layers"].items():
        if isinstance(leaf, LoraLinear):
            jtuned["layers"][name] = JLoraLinear(
                base=jbase["layers"][name], a=jnp.asarray(leaf.a.numpy()),
                b=jnp.asarray(leaf.b.numpy()), scale=leaf.scale)
    jmerged = jt.merge_lora(jtuned, dtype=jnp.float32)
    for name in tt.lora.DEFAULT_TARGETS:
        np.testing.assert_allclose(merged["layers"][name].numpy(),
                                   np.asarray(jmerged["layers"][name]), atol=1e-6)


def test_merge_lora_over_quantized_base_matches_jax():
    """`merge_lora` over int8 and int4 bases, to bf16: JAX's bytes (f32
    sums in another order may round to a neighbouring bf16: at most one
    bf16 step, on under 1% of the weights)."""
    for quant in (dict(bits=8), dict(bits=4)):
        jp, tp = both(6, quant=quant, lora=dict(rank=4))
        rng = np.random.default_rng(6)
        for name in tt.lora.DEFAULT_TARGETS:  # non-zero B on both sides
            b = rng.standard_normal(tuple(tp["layers"][name].b.shape)).astype(np.float32) * 0.1
            tp["layers"][name].b = torch.from_numpy(b)
            jp["layers"][name] = JLoraLinear(
                base=jp["layers"][name].base, a=jp["layers"][name].a, b=jnp.asarray(b),
                scale=jp["layers"][name].scale)
        got, want = tt.merge_lora(tp), jt.merge_lora(jp)
        for name in tt.lora.DEFAULT_TARGETS:
            g = got["layers"][name]
            w = np.asarray(want["layers"][name].astype(jnp.float32))
            assert g.dtype == torch.bfloat16
            diff = np.abs(g.float().numpy() - w)
            assert (diff <= 2 ** -7 * np.abs(w) + 1e-30).all()
            assert (diff > 0).mean() < 0.01


def test_tied_head_trains_two_leaves_like_jax():
    """A tied config: the port's lm_head is a view of the embedding, JAX's a
    new array. The state holds a copy of each, so embed and lm_head drift
    apart as in JAX: 6 Adam steps, losses rtol 1e-4, leaves by
    `assert_leaves_close`, embed ≠ lm_headᵀ after training; the caller's
    tree is untouched."""
    cfg = CFG.replace(tie_word_embeddings=True)
    tcfg = port_config(cfg)
    jp = jinit(cfg, seed=7, dtype=jnp.float32)
    tp = to_port(jp)
    tp["lm_head"] = tp["embed"].T  # the port's tie: a view of one storage
    embed0 = tp["embed"].clone()
    batches = [make_batch(7)] * 6
    jl, jleaves, _ = run_jax(jp, optax.adam(5e-3), jt.trainable_full, batches, cfg)
    tl, tleaves, _ = run_port(tp, lambda ps: torch.optim.Adam(ps, lr=5e-3),
                              tt.trainable_full, batches, tcfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    names = [keystr(p) for p, _ in tree_flatten_with_path(tp)[0]]
    flags = tt.partition(tp, tt.trainable_full)[2][1]
    trained = dict(zip([n for n, f in zip(names, flags) if f], tleaves))
    assert np.abs(trained["['embed']"] - trained["['lm_head']"].T).max() > 1e-3
    assert torch.equal(tp["embed"], embed0)
    start = [np.asarray(x) for x in jt.partition(jp, jt.trainable_full)[0]]
    assert_leaves_close(tleaves, jleaves, start)


def test_act8_base_gradients_match_jax():
    """A W8A8 and a W4A8 base (per-channel, int8 activations): the
    gradient reaches x only through each token's activation scale (round
    and the int cast carry none), in both packages. LoRA and norm
    gradients atol 1e-5 against JAX's."""
    for bits in (8, 4):
        quant = dict(bits=bits, group_size=None, act_bits=8)
        jp, tp = both(8, quant=quant, lora=dict(rank=4))
        batch = make_batch(8)
        for pred in (jt.trainable_lora, jt.trainable_full):
            tpred = tt.trainable_lora if pred is jt.trainable_lora else tt.trainable_full
            want = _jax_grads(jp, batch, False, pred)
            got = _port_grads(tp, batch, False, tpred)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_differentiable_route_reaches_no_kernel(monkeypatch):
    """With every kernel wrapper made to raise, the loss and its gradients
    run: weight-only bases at ≤ 32 rows (the dequant-matmul kernel's range
    at inference) and windows past 16 tokens (flash attention's)."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((ttransformer, "flash_attention"), (ttransformer, "decode_attention"),
                      (ttransformer, "decode_attention_quantized"),
                      (ttransformer, "paged_decode_attention")):
        monkeypatch.setattr(mod, name, refuse)
    from metalchat_tpu_torch.quant import quantize as tq

    monkeypatch.setattr(tq, "dequant_matmul", refuse)
    _, tp = both(9, quant=dict(bits=4), lora=dict(rank=4))
    for b, s in ((1, 16), (2, 24)):  # 15 rows; 23 tokens past the flash cut
        batch = make_batch(9, b=b, s=s)
        assert len(_port_grads(tp, batch, True, tt.trainable_lora)) == 14
    with pytest.raises(AssertionError, match="kernel wrapper"):  # the patch is live
        ttransformer.forward(tp, KVCache.create(TCFG, 1, 32, device="cpu"),
                             torch.zeros((1, 20), dtype=torch.long), 0, TCFG)


def test_kernel_gate_raises_under_grad():
    """`_build.require_cuda` refuses an operand that requires grad while grad
    mode is on (no kernel defines a backward) and names the kernel; without
    grad it goes on to its device checks. Meta tensors stand in for the
    card's."""
    x = torch.empty(4, 8, device="meta", requires_grad=True)
    w = torch.empty(8, 8, device="meta")
    with pytest.raises(RuntimeError, match="quant_matmul: an operand requires grad"):
        _build.require_cuda("quant_matmul", x, w)
    with torch.no_grad(), pytest.raises(RuntimeError, match="no kernel for device meta"):
        _build.require_cuda("quant_matmul", x, w)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        _build.require_cuda("quant_matmul", x.detach(), w)


def test_differentiable_forward_writes_the_cache_and_reads_earlier_rows():
    """`forward(differentiable=True)` writes k and v into the cache as the
    inference route does, and at a later start position attends over the
    rows already there: logits equal the layer route's (atol 1e-5). It
    takes a dense cache only."""
    _, tp = both(10)
    tokens = torch.from_numpy(make_batch(10, b=2, s=20)["tokens"]).long()
    c1 = KVCache.create(TCFG, 2, 32, device="cpu")
    c2 = KVCache.create(TCFG, 2, 32, device="cpu")
    ttransformer.forward(tp, c1, tokens[:, :12], 0, TCFG, fast_decode=False)
    want, _ = ttransformer.forward(tp, c1, tokens[:, 12:], 12, TCFG, fast_decode=False)
    ttransformer.forward(tp, c2, tokens[:, :12], 0, TCFG, differentiable=True)
    got, _ = ttransformer.forward(tp, c2, tokens[:, 12:], 12, TCFG, differentiable=True)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="dense KVCache"):  # no gradient through int8 codes
        ttransformer.forward(tp, QuantizedKVCache.create(TCFG, 2, 32, device="cpu"),
                             tokens[:, :4], 0, TCFG, differentiable=True)


# -- MoE ------------------------------------------------------------------------

def _moe_params(seed):
    """JAX's Mixtral init with the router scaled up (logits of about unit
    spread), so that top-2 routing is decided and ulp-level differences do
    not flip an expert."""
    jp = jinit(MOE_CFG, seed=seed, dtype=jnp.float32)
    jp = dict(jp, layers=dict(jp["layers"], router=jp["layers"]["router"] * 50.0))
    return jp, to_port(jp)


def test_load_balancing_loss_matches_jax():
    """`load_balancing_loss` on [B, S, H] activations: rtol 1e-6."""
    jp, tp = _moe_params(11)
    x = np.random.default_rng(11).standard_normal((2, 64, 32)).astype(np.float32)
    for l in range(2):
        want = float(jload_balancing_loss(jnp.asarray(x), jp["layers"]["router"][l],
                                          MOE_CFG))
        got = tmoe.load_balancing_loss(torch.from_numpy(x), tp["layers"]["router"][l],
                                       port_config(MOE_CFG))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        assert 0.9 < want < MOE_CFG.num_experts + 0.1


@pytest.mark.parametrize("differentiable", [False, True])
def test_forward_with_aux_matches_jax(differentiable):
    """`forward(with_aux=True)`: the mean of the layers' aux, rtol 1e-5
    (dispatch scheme at 80 tokens), and an exact 0.0 for a dense model,
    on either route."""
    jp, tp = _moe_params(12)
    tokens = make_batch(12, b=2, s=40)["tokens"]
    jc = JKVCache.create(MOE_CFG, 2, 64, dtype=jnp.float32)
    _, _, want = jforward(jp, jc, jnp.asarray(tokens), 0, MOE_CFG, with_aux=True,
                          differentiable=differentiable)
    tc = KVCache.create(port_config(MOE_CFG), 2, 64, dtype=torch.float32, device="cpu")
    _, _, got = ttransformer.forward(tp, tc, torch.from_numpy(tokens).long(), 0,
                                     port_config(MOE_CFG), with_aux=True,
                                     differentiable=differentiable)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _, dense = both(5)
    for fast in (True, False):  # decode_step at one token, or the layer route
        _, _, aux0 = ttransformer.forward(
            dense, KVCache.create(TCFG, 2, 32, device="cpu"),
            torch.from_numpy(tokens[:, :1]).long(), 0, TCFG, with_aux=True,
            fast_decode=fast, differentiable=differentiable)
        assert float(aux0) == 0.0


def test_moe_training_with_aux_matches_jax():
    """`moe_aux_weight=0.01` training (tests/test_moe.py's, Adam 3e-3, 8
    steps at 4 × 40 tokens): losses rtol 1e-4 against JAX's, descending;
    leaves by `assert_leaves_close`."""
    jp, tp = _moe_params(3)
    batches = [make_batch(3, b=4, s=40)] * 8
    jl, jleaves, _ = run_jax(jp, optax.adam(3e-3), jt.trainable_full, batches, MOE_CFG,
                             functools.partial(jt.causal_lm_loss, moe_aux_weight=0.01))
    tl, tleaves, _ = run_port(tp, lambda ps: torch.optim.Adam(ps, lr=3e-3),
                              tt.trainable_full, batches, port_config(MOE_CFG),
                              functools.partial(tt.causal_lm_loss, moe_aux_weight=0.01))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] - 0.05
    start = [np.asarray(x) for x in jt.partition(jp, jt.trainable_full)[0]]
    assert_leaves_close(tleaves, jleaves, start)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,batch,seed,drop_last,epochs",
                         [(4, 2, 0, False, 1), (16, 4, 1, True, 3), (7, 3, None, False, 2)])
def test_packed_dataset_matches_jax(seq_len, batch, seed, drop_last, epochs):
    """Windows, masks and every batch exactly equal to the JAX package's."""
    from metalchat_tpu.train import PackedDataset as JPackedDataset

    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 128, rng.integers(1, 40)).tolist() for _ in range(9)]
    j, t = JPackedDataset(docs, seq_len, eos_id=0), tt.PackedDataset(docs, seq_len, eos_id=0)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.loss_mask, j.loss_mask)
    assert t.tokens.dtype == j.tokens.dtype and t.loss_mask.dtype == j.loss_mask.dtype
    jb = list(j.batches(batch, seed=seed, epochs=epochs, drop_last=drop_last))
    tb = list(t.batches(batch, seed=seed, epochs=epochs, drop_last=drop_last))
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        for k in ("tokens", "loss_mask"):
            np.testing.assert_array_equal(a[k], b[k])


def test_packed_dataset_feeds_train_step():
    """tests/test_train.py's data case on the port: the loss descends over
    3 epochs of packed batches."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 128, rng.integers(5, 40)).tolist() for _ in range(8)]
    ds = tt.PackedDataset(docs, seq_len=16, eos_id=0)
    _, tp = both(7)
    losses, _, _ = run_port(tp, lambda ps: torch.optim.Adam(ps, lr=1e-3), tt.trainable_full,
                            list(ds.batches(4, seed=1, epochs=3)))
    assert len(losses) >= 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


# -- train-state files --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_save_load_resume_is_bit_identical(tmp_path, name):
    """Save after 3 steps, load into a fresh template: the step count, every
    leaf and the next step's loss and leaves are bit-identical to going
    on without the file."""
    _, tp = both(8)
    trainable, frozen, spec = tt.partition(tp, tt.trainable_full)
    init, step = tt.make_train_step(TCFG, OPTIMIZERS[name][1], spec)
    state = init(trainable)
    batch = make_batch(8)
    for _ in range(3):
        state, _ = step(state, frozen, batch)
    path = str(tmp_path / "state.safetensors")
    tt.save_train_state(path, state)
    restored = tt.load_train_state(path, init(trainable))
    assert int(restored.step) == 3 and restored.step.dtype == torch.int32
    s1, m1 = step(state, frozen, batch)
    s2, m2 = step(restored, frozen, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(s1.trainable, s2.trainable):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_jax_train_state_file_resumes_in_the_port(tmp_path, name):
    """A file that JAX's `save_train_state` wrote after 3 steps loads into
    the port (the optimizer state through `convert.set_optimizer_state`):
    the port's next step gives JAX's next loss (rtol 1e-5) and leaves (atol
    1e-5 for SGD; for Adam 1% of its lr, 5e-5: an element with a gradient
    at the noise floor, module docstring); and the port's own file of that
    state loads into JAX bit for bit."""
    jp, tp = both(13)
    batch = make_batch(13)
    j_opt, t_opt = OPTIMIZERS[name]
    t, f, spec = jt.partition(jp, jt.trainable_full)
    jinit_state, jstep = jt.make_train_step(CFG, j_opt(), spec)
    state = jinit_state(t)
    for _ in range(3):
        state, _ = jstep(state, f, jbatch(batch))
    path = str(tmp_path / "jax.safetensors")
    jt.save_train_state(path, state)
    jnext, jm = jstep(state, f, jbatch(batch))

    trainable, frozen, tspec = tt.partition(tp, tt.trainable_full)
    init, step = tt.make_train_step(TCFG, t_opt, tspec)
    restored = tt.load_train_state(path, init(trainable))
    assert int(restored.step) == 3
    for a, b in zip(restored.trainable, state.trainable):
        assert np.array_equal(a.detach().numpy(), np.asarray(b))
    port_path = str(tmp_path / "port.safetensors")
    tt.save_train_state(port_path, restored)
    back = jt.load_train_state(port_path, jinit_state(t))
    for a, b in zip(jax.tree_util.tree_leaves((back.trainable, back.opt_state, back.step)),
                    jax.tree_util.tree_leaves((state.trainable, state.opt_state, state.step))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    tnext, tm = step(restored, frozen, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for a, b in zip(tnext.trainable, jnext.trainable):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=5e-5 if name == "adam" else 1e-5)


def test_optimizer_state_layout_is_optax():
    """`set_optimizer_state` refuses a leaf count that is not the optimizer's
    optax layout (Adam 2n + 1, SGD with momentum n, SGD 0)."""
    ps = [torch.zeros(3, requires_grad=True), torch.zeros(2, requires_grad=True)]
    adam, sgd = torch.optim.Adam(ps), torch.optim.SGD(ps, lr=0.1, momentum=0.9)
    set_optimizer_state(adam, ps, [np.int32(4), *[np.ones(p.shape) for p in ps] * 2])
    assert float(adam.state[ps[1]]["step"]) == 4.0
    with pytest.raises(ValueError, match="takes 5 state leaves"):
        set_optimizer_state(adam, ps, [])
    with pytest.raises(ValueError, match="takes 2 state leaves"):
        set_optimizer_state(sgd, ps, [])
    set_optimizer_state(torch.optim.SGD(ps, lr=0.1), ps, [])
    with pytest.raises(NotImplementedError):
        set_optimizer_state(torch.optim.RMSprop(ps), ps, [])
