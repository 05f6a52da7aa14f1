"""Three public functions of the JAX package that the port keeps for parity
(metalchat_tpu_torch/io/safetensors.py `save_sharded_safetensors`,
sampling.py `multinomial`, utils/profiling.py `profile_to`) against the JAX
package's, on the CPU, with inputs made from a seed with numpy.

Tolerances: the sharded checkpoint's file names, index JSON and every
shard's bytes equal to JAX's; `multinomial`'s ids equal to JAX's for the
same uniforms (JAX's own draw from its key, handed to the port); a
traced region's name in both profilers' traces.
"""

import gzip
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from metalchat_tpu import sampling as jsampling
from metalchat_tpu.io.safetensors import save_sharded_safetensors as jsave_sharded
from metalchat_tpu.utils import profiling as jprofiling
from metalchat_tpu_torch import sampling
from metalchat_tpu_torch.io import open_safetensors, save_sharded_safetensors
from metalchat_tpu_torch.utils import profiling


def _tensors(seed: int):
    """Mixed dtypes and sizes (numpy for JAX's writer, torch for the port's)."""
    rng = np.random.default_rng(seed)
    arrays = {
        "embed": rng.standard_normal((64, 32)).astype(np.float32),
        "layers.0.wq": rng.standard_normal((32, 32)).astype(ml_dtypes.bfloat16),
        "layers.0.q": rng.integers(-128, 128, (48, 16), dtype=np.int8),
        "layers.0.norm": rng.standard_normal(32).astype(np.float16),
        "layers.1.wq": rng.standard_normal((32, 32)).astype(ml_dtypes.bfloat16),
        "lm_head": rng.standard_normal((32, 64)).astype(np.float32),
        "step": np.asarray([7], np.int64),
    }
    tensors = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                   if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
               for k, v in arrays.items()}
    return arrays, tensors


@pytest.mark.parametrize("max_shard_bytes", [1, 3000, 9000, 5 * 1024 ** 3])
def test_save_sharded_safetensors_matches_jax(tmp_path, max_shard_bytes):
    arrays, tensors = _tensors(0)
    meta = {"format": "pt"}
    jindex = jsave_sharded(tmp_path / "jax", arrays, max_shard_bytes=max_shard_bytes,
                           metadata=meta)
    index = save_sharded_safetensors(tmp_path / "port", tensors,
                                     max_shard_bytes=max_shard_bytes, metadata=meta)
    assert index.name == jindex.name == "model.safetensors.index.json"
    assert index.read_bytes() == jindex.read_bytes()
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    doc = open_safetensors(tmp_path / "port")
    for k, t in tensors.items():
        assert torch.equal(doc.torch_tensor(k), t)


@pytest.mark.parametrize("shape", [(16, 50), (3, 5, 7), (1000,)])
def test_multinomial_matches_jax(shape):
    """The inverse-CDF draw: the same ids as JAX's for the uniforms JAX
    drew from its key; unnormalized rows too (the draw scales by the
    row's total)."""
    rng = np.random.default_rng(1)
    probs = rng.random(shape).astype(np.float32) ** 3
    key = jax.random.PRNGKey(2)
    want = np.asarray(jsampling.multinomial(jnp.asarray(probs), key))
    uniforms = np.asarray(jax.random.uniform(key, probs.shape[:-1] + (1,), dtype=jnp.float32))
    got = sampling.multinomial(torch.from_numpy(probs), uniforms=torch.tensor(uniforms))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = sampling.multinomial(torch.from_numpy(probs),
                                 torch.Generator().manual_seed(3))
    assert drawn.dtype == torch.int32 and bool(((drawn >= 0) & (drawn < shape[-1])).all())


def test_profile_to_writes_a_trace_like_jax(tmp_path):
    """Both write a trace file under the directory that names the traced
    region (JAX: plugins/profile/<run>/*.trace.json.gz; the port:
    *.pt.trace.json)."""
    with jprofiling.profile_to(str(tmp_path / "jax")):
        with jprofiling.trace("leftovers-region"):
            jnp.ones(64).sum().block_until_ready()
    with profiling.profile_to(str(tmp_path / "port")):
        with profiling.trace("leftovers-region"):
            torch.ones(64).sum()
    (jtrace,) = Path(tmp_path / "jax").rglob("*.trace.json.gz")
    assert b"leftovers-region" in gzip.decompress(jtrace.read_bytes())
    (trace,) = Path(tmp_path / "port").glob("*.pt.trace.json")
    assert "leftovers-region" in trace.read_text()
