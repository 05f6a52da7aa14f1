"""PyTorch/CUDA port of metalchat_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``metalchat_tpu`` stays the reference. This package imports
``torch``, numpy and the standard library only, never ``jax`` and nothing of
``metalchat_tpu``; where it needs a jax-free module of the JAX package it
keeps its own copy. Its TPU kernels are hand-written CUDA under ``csrc/``,
each beside a plain PyTorch version (``ops/``).

Entry points take ``device=None``, meaning the card; they raise when CUDA is
missing. The CPU runs only when the caller passes ``device="cpu"``.
"""
