"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

Data crosses between the two frameworks only as numpy arrays: the JAX side
is computed and taken to numpy before any torch op runs.
"""

import numpy as np

from metalchat_tpu.quant.quantize import QuantizedTensor


def jax_tree_to_numpy(tree):
    """JAX parameter tree → nested dicts of numpy arrays, quantized leaves as
    the dicts `metalchat_tpu_torch.convert.params_from_numpy` takes."""
    if isinstance(tree, QuantizedTensor):
        assert tree.pack_chunks == 1 and tree.fuse_tp == 1
        return {"q": np.asarray(tree.q), "scales": np.asarray(tree.scales),
                "bits": tree.bits, "group_size": tree.group_size,
                "transposed": tree.transposed, "act_bits": tree.act_bits}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
