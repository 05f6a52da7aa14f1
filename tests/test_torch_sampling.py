"""Port sampling masks and Llama config (metalchat_tpu_torch/sampling.py,
config.py) vs the JAX package's sampling.py and config.py, on the CPU.

The masks keep or drop the same tokens and leave kept logits untouched, so
the comparison is exact. Stochastic draws are not compared: a
``torch.Generator`` and a JAX key give different numbers from one seed.
`sample_batched` with device tensors (the engine's captured step) is held
to its host-sequence call and recorded at the aten level: no read back, no
copy from the host.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metalchat_tpu import sampling as jsampling
from metalchat_tpu.config import LlamaConfig as JLlama
from metalchat_tpu_torch import sampling
from metalchat_tpu_torch.config import LlamaConfig

# The suite runs test files in parallel workers on shared cores: one torch
# thread per worker keeps these small ops from crowding the others.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "pyllama_10m"
LOGITS = np.random.default_rng(0).standard_normal((4, 97)).astype(np.float32) * 3


@pytest.mark.parametrize("name,arg", [
    ("top_k_mask", 5), ("top_k_mask", 0), ("top_p_mask", 0.7), ("top_p_mask", 1.0),
    ("min_p_mask", 0.1), ("min_p_mask", 0.0),
])
def test_masks_identical(name, arg):
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(LOGITS), arg))

    got = getattr(sampling, name)(torch.from_numpy(LOGITS), arg).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_and_stochastic_sample():
    want = np.asarray(jsampling.sample(jnp.asarray(LOGITS), None,
                                       jsampling.SamplerConfig.greedy()))

    logits = torch.from_numpy(LOGITS)
    np.testing.assert_array_equal(
        sampling.sample(logits, None, sampling.SamplerConfig.greedy()).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    cfg = sampling.SamplerConfig(temperature=0.8, top_k=5, top_p=0.9)
    kept = torch.isfinite(sampling.top_k_mask(logits / 0.8, 5))
    for _ in range(8):
        ids = sampling.sample(logits, gen, cfg)
        assert kept[torch.arange(4), ids].all()  # draws only from the top-k
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample(logits, None, cfg)


def _as_dict(cfg):
    """The port's config fields, read from either package's config."""
    out = {f: getattr(cfg, f) for f in LlamaConfig.__dataclass_fields__}
    out["rope_scaling"] = None if cfg.rope_scaling is None else vars(cfg.rope_scaling)
    return out


def test_llama_configs_match():
    raw = json.loads((FIXTURE / "config.json").read_text())
    hf_8b = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
             "rope_scaling": {"rope_type": "llama3", "factor": 8.0}, "eos_token_id": 7}
    want = [_as_dict(c) for c in (JLlama.llama31_8b(max_seq_len=1024), JLlama.llama32_1b(),
                                  JLlama.from_hf_config(raw), JLlama.from_hf_config(hf_8b))]

    got = [_as_dict(c) for c in (LlamaConfig.llama31_8b(max_seq_len=1024),
                                 LlamaConfig.llama32_1b(), LlamaConfig.from_hf_config(raw),
                                 LlamaConfig.from_hf_config(hf_8b))]
    assert got == want


# sample_batched: per-row settings (temperature, top-k, top-p); row 0 and
# row 3 are greedy, the others restricted by k, by p or by both.
BATCH_LOGITS = np.random.default_rng(1).standard_normal((6, 97)).astype(np.float32) * 2
TEMPS = np.array([0.0, 0.7, 1.0, -1.0, 1.3, 0.9], np.float32)
TOP_K = np.array([0, 5, 0, 3, 12, 0], np.int32)
TOP_P = np.array([1.0, 1.0, 0.8, 0.5, 0.6, 1.0], np.float32)


def _exact_keep(row: int) -> np.ndarray:
    """The kept set the bisection approximates: fewer than k values above x,
    and probability mass strictly above x below p (f64), plus the argmax."""
    x = BATCH_LOGITS[row].astype(np.float64) / TEMPS[row]
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    above = x[None, :] > x[:, None]                    # [i, j]: x_j > x_i
    keep = np.ones(x.shape, bool)
    if TOP_K[row] > 0:
        keep &= above.sum(axis=1) < TOP_K[row]
    if TOP_P[row] < 1.0:
        mass = (above * probs[None, :]).sum(axis=1)
        assert np.abs(mass - TOP_P[row]).min() > 1e-4  # no element near the edge
        keep &= mass < TOP_P[row]
    keep[x.argmax()] = True
    return keep


def test_sample_batched_greedy_rows_match_jax():
    import jax

    want = np.asarray(jsampling.sample_batched(
        jnp.asarray(BATCH_LOGITS), jax.random.PRNGKey(0), jnp.asarray(TEMPS),
        jnp.asarray(TOP_K), jnp.asarray(TOP_P)))

    gen = torch.Generator().manual_seed(0)
    got = sampling.sample_batched(torch.from_numpy(BATCH_LOGITS), gen, TEMPS, TOP_K,
                                  TOP_P).numpy()
    greedy = TEMPS <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], BATCH_LOGITS[greedy].argmax(-1))
    all_greedy = sampling.sample_batched(torch.from_numpy(BATCH_LOGITS), None,
                                         np.zeros(6), TOP_K, TOP_P)
    np.testing.assert_array_equal(all_greedy.numpy(), BATCH_LOGITS.argmax(-1))


def _tensors(temps, top_k, top_p):
    return (torch.from_numpy(temps), torch.from_numpy(top_k), torch.from_numpy(top_p),
            sampling.sampling_branch(temps, top_k, top_p))


class _AtenLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the aten ops a call makes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


SETTINGS = {"truncate": (TEMPS, TOP_K, TOP_P),
            "draw": (TEMPS, np.zeros(6, np.int32), np.ones(6, np.float32)),
            "greedy": (np.minimum(TEMPS, 0), TOP_K, TOP_P)}


@pytest.mark.parametrize("branch", list(SETTINGS))
def test_sample_batched_device_tensors(branch):
    """Settings as tensors equal the host-sequence call (greedy ids, and
    draws from one generator seed, four calls in a row); the greedy rows
    equal JAX's; the draws lie in the exact kept sets; the call reads
    nothing back (no ``_local_scalar_dense``) and makes no tensor from host
    data."""
    import jax

    settings = SETTINGS[branch]
    temps, top_k, top_p, got_branch = _tensors(*settings)
    assert got_branch == branch
    logits = torch.from_numpy(BATCH_LOGITS)
    gen_host, gen_dev = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(4):
        want = sampling.sample_batched(logits, gen_host, *settings)
        log = _AtenLog()
        with log:
            got = sampling.sample_batched(logits, gen_dev, temps, top_k, top_p, branch)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert not [op for op in log.ops if "_local_scalar_dense" in op or "lift_fresh" in op
                    or op.startswith("aten._to_copy")], log.ops
        greedy = settings[0] <= 0
        jax_ids = np.asarray(jsampling.sample_batched(
            jnp.asarray(BATCH_LOGITS), jax.random.PRNGKey(0), *map(jnp.asarray, settings)))
        np.testing.assert_array_equal(got.numpy()[greedy], jax_ids[greedy])
        if branch == "truncate":
            for r in (1, 2, 4):
                assert _exact_keep(r)[got[r]]
    with pytest.raises(ValueError, match="branch"):
        sampling.sample_batched(logits, gen_dev, temps, top_k, top_p)


def test_sample_batched_kept_sets_are_exact():
    """The port's bisection keeps exactly the set it approximates, on
    tie-free logits; the port's draws and JAX's (16 keys) fall inside it."""
    import jax

    restricted = [r for r in range(6) if TEMPS[r] > 0 and (TOP_K[r] > 0 or TOP_P[r] < 1)]
    assert restricted == [1, 2, 4]
    safe_t = np.where(TEMPS <= 0, 1.0, TEMPS).astype(np.float32)
    scaled = torch.from_numpy(BATCH_LOGITS) / torch.from_numpy(safe_t)[:, None]
    keep = sampling.truncation_keep(scaled, torch.from_numpy(TOP_K).long(),
                                    torch.from_numpy(TOP_P)).numpy()
    exact = {r: _exact_keep(r) for r in restricted}
    for r in restricted:
        np.testing.assert_array_equal(keep[r], exact[r])
        assert 1 < exact[r].sum() < 97
    gen = torch.Generator().manual_seed(3)
    logits = torch.from_numpy(BATCH_LOGITS)
    for i in range(16):
        got = sampling.sample_batched(logits, gen, TEMPS, TOP_K, TOP_P).numpy()
        drawn = np.asarray(jsampling.sample_batched(
            jnp.asarray(BATCH_LOGITS), jax.random.PRNGKey(i), jnp.asarray(TEMPS),
            jnp.asarray(TOP_K), jnp.asarray(TOP_P)))
        for r in restricted:
            assert exact[r][got[r]] and exact[r][drawn[r]]
