"""Tools that drive the port, each a module with a command line:

* ``python -m metalchat_tpu_torch.tools.train_fixture --out DIR``: trains a
  byte-level Llama on local Python source (the kind of model
  ``tests/fixtures/pyllama_10m`` is);
* ``python -m metalchat_tpu_torch.tools.quality_gate``: perplexity of every
  quantization scheme against bf16, written to ``QUALITY_torch.json`` and
  ``QUALITY_torch.md``;
* ``python -m metalchat_tpu_torch.tools.quality_tp``: teacher-forced
  perplexity through the decode path in one process and over two
  tensor-parallel ranks.

Each runs on the card unless given ``--device cpu``.
"""
