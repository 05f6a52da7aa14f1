"""Train a byte-level Llama on local Python source: the kind of model the
repository's ``tests/fixtures/pyllama_10m`` is (the port of the JAX
package's ``tools/train_fixture.py``, on `metalchat_tpu_torch.train`).

The corpus is the ``*.py`` files of this interpreter's site-packages (a
deterministic train/eval split by the path's md5), so nothing is
downloaded. The optimizer is the JAX tool's ``optax.adamw`` (β 0.9, 0.95,
weight decay 0.01) under ``warmup_cosine_decay_schedule(0, lr, 100, steps,
lr / 10)``, here `torch.optim.AdamW` with the schedule's value set before
each step, at optax's count: the first step runs at lr 0.

Run:  python -m metalchat_tpu_torch.tools.train_fixture --out DIR
      [--steps 3000] [--batch 32] [--seq 512] [--size 10m|50m] [--device cuda]

``--out`` has no default, so the tool never writes over the committed
fixture unless it is named. Writes ``model.safetensors`` (bf16),
``config.json``, ``eval_tokens.npy`` (the held-out bytes, uint16), a
byte-level ``tokenizer.model`` and ``train_meta.json``.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import math
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metalchat_tpu_torch.config import LlamaConfig
from metalchat_tpu_torch.device import resolve_device
from metalchat_tpu_torch.io.loaders import save_params
from metalchat_tpu_torch.io.safetensors import save_safetensors
from metalchat_tpu_torch.models.transformer import init_random_params
from metalchat_tpu_torch.train.step import combine, make_train_step, partition, trainable_full

BOS = 256
VOCAB = 384  # 256 bytes + bos + padding to a multiple of 128
WARMUP = 100


def harvest_corpus(max_train_mb: int = 192, max_eval_mb: int = 2) -> Tuple[bytes, bytes]:
    """Deterministic train and eval byte corpora from site-packages .py files."""
    import site

    files = []
    for root in site.getsitepackages():
        for dirpath, _, names in os.walk(root):
            files.extend(os.path.join(dirpath, n) for n in names if n.endswith(".py"))
    files.sort()
    train, evals = [], []
    train_sz = eval_sz = 0
    for f in files:
        try:
            sz = os.path.getsize(f)
        except OSError:
            continue
        if sz > 512 * 1024 or sz < 256:  # generated monsters and stubs
            continue
        is_eval = int(hashlib.md5(f.encode()).hexdigest(), 16) % 50 == 0
        if is_eval and eval_sz < max_eval_mb * 1e6:
            evals.append(f)
            eval_sz += sz
        elif not is_eval and train_sz < max_train_mb * 1e6:
            train.append(f)
            train_sz += sz

    def read_all(paths):
        bufs = []
        for p in paths:
            try:
                with open(p, "rb") as fh:
                    bufs.append(fh.read())
            except OSError:
                pass
        return b"\n\n".join(bufs)

    tr, ev = read_all(train), read_all(evals)
    print(f"corpus: train {len(tr)/1e6:.1f} MB ({len(train)} files), "
          f"eval {len(ev)/1e6:.1f} MB ({len(evals)} files)")
    return tr, ev


def make_config(size: str = "10m") -> LlamaConfig:
    if size == "50m":
        # About 5x the 10M fixture, for the claim that small models amplify
        # quantization error.
        return LlamaConfig(
            vocab_size=VOCAB, hidden_size=768, intermediate_size=2304,
            num_layers=10, num_heads=12, num_kv_heads=4, head_dim=64,
            max_seq_len=1024, rope_theta=10000.0, tie_word_embeddings=False,
        )
    return LlamaConfig(
        vocab_size=VOCAB, hidden_size=384, intermediate_size=1024,
        num_layers=6, num_heads=6, num_kv_heads=3, head_dim=64,
        max_seq_len=1024, rope_theta=10000.0, tie_word_embeddings=False,
    )


def batches(data: np.ndarray, batch: int, seq: int, steps: int, seed: int = 0) -> np.ndarray:
    """[steps, batch, seq + 1] random crops (the labels are the inputs
    shifted by one)."""
    rng = np.random.default_rng(seed)
    n = len(data) - (seq + 1)
    starts = rng.integers(0, n, size=(steps, batch))
    out = np.empty((steps, batch, seq + 1), np.int32)
    for i in range(steps):
        for j, s in enumerate(starts[i]):
            out[i, j] = data[s:s + seq + 1]
    return out


def lr_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, WARMUP, steps, lr /
    10)`` at a step count: a linear warmup from 0, then a cosine from lr to
    lr / 10 over ``steps - WARMUP`` steps, flat after. Like optax, refuses
    ``steps <= WARMUP``."""
    decay = steps - WARMUP
    if not decay > 0:
        raise ValueError(f"the cosine decay needs steps > {WARMUP} (its warmup), got {steps}")
    alpha = 0.1

    def at(count: int) -> float:
        if count < WARMUP:
            return lr * count / WARMUP
        t = min(count - WARMUP, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return at


def train_steps(params, cfg: LlamaConfig, data: np.ndarray, *, lr: float, steps: int,
                chunk: int = 50, remat: bool = False,
                log: Optional[Callable[[str], None]] = print):
    """Train every float leaf of ``params`` (f32, on its device) on
    ``data`` ``[n, B, S + 1]``: one AdamW step a row of ``data``, the first
    n steps of a ``steps``-step schedule (`lr_schedule`). Returns (the
    trained tree, one loss a step). The losses are read back once a
    ``chunk`` of steps."""
    device = params["final_norm"].device
    trainable, frozen, spec = partition(params, trainable_full)
    init_state, step_fn = make_train_step(
        cfg, lambda ps: torch.optim.AdamW(ps, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                                          weight_decay=0.01),
        spec, remat=remat)
    state = init_state(trainable)
    sched = lr_schedule(lr, steps)
    n, rows, width = data.shape
    mask = torch.ones(rows, width - 1, device=device)
    losses: List[float] = []
    t0 = time.perf_counter()
    for c in range(0, n, chunk):
        part = torch.from_numpy(np.ascontiguousarray(data[c:c + chunk])).to(device)
        pending = []
        for i, toks in enumerate(part):
            for group in state.opt_state.param_groups:
                group["lr"] = sched(c + i)
            state, metrics = step_fn(state, frozen, {"tokens": toks, "loss_mask": mask})
            pending.append(metrics["loss"])
        chunk_losses = torch.stack(pending).tolist()
        losses.extend(chunk_losses)
        if log is not None:
            done = c + len(chunk_losses)
            log(f"step {done:5d}/{n}  loss {chunk_losses[-1]:.4f}  "
                f"({done / (time.perf_counter() - t0):.1f} steps/s)")
    return combine([t.detach() for t in state.trainable], frozen, spec), losses


def save_fixture(params, cfg: LlamaConfig, eval_data: np.ndarray, losses: Sequence[float],
                 args) -> None:
    """Write the fixture's five files into ``args.out`` (the weights in
    bf16; the rope tables are recomputed at load). ``args`` carries out,
    steps, batch, seq and lr."""
    bf16 = {k: v for k, v in params.items() if k != "rope"}
    bf16 = {**{k: v.to(torch.bfloat16) for k, v in bf16.items() if k != "layers"},
            "layers": {k: v.to(torch.bfloat16) for k, v in params["layers"].items()}}
    save_safetensors(os.path.join(args.out, "model.safetensors"), save_params(bf16, cfg))
    with open(os.path.join(args.out, "config.json"), "w") as fh:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_seq_len,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": False,
            "torch_dtype": "bfloat16",
        }, fh, indent=1)
    np.save(os.path.join(args.out, "eval_tokens.npy"), eval_data.astype(np.uint16))
    # A byte-level tiktoken tokenizer (ranks 0..255 are the bytes), so the
    # CLI's whole path runs against the fixture.
    lines = [f"{base64.b64encode(bytes([b])).decode()} {b}" for b in range(256)]
    with open(os.path.join(args.out, "tokenizer.model"), "w") as fh:
        fh.write("\n".join(lines))
    with open(os.path.join(args.out, "train_meta.json"), "w") as fh:
        json.dump({
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "lr": args.lr, "final_loss": losses[-1],
            "loss_tail": list(losses[-20:]),
            "corpus": "site-packages *.py (byte-level, md5%50 eval split)",
        }, fh, indent=1)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m metalchat_tpu_torch.tools.train_fixture",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=50, help="steps per host read of the losses")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", required=True,
                    help="output directory (no default: the committed fixture is "
                         "overwritten only if named)")
    ap.add_argument("--size", choices=["10m", "50m"], default="10m")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                    help="recompute each layer's activations in the backward pass "
                         "(default: on for 50m)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.remat is None:
        args.remat = args.size == "50m"
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_config(args.size)
    train_bytes, eval_bytes = harvest_corpus()
    train_data = np.frombuffer(train_bytes, np.uint8).astype(np.int32)
    eval_data = np.frombuffer(eval_bytes, np.uint8).astype(np.int32)
    params = init_random_params(cfg, seed=0, dtype=torch.float32, max_seq_len=args.seq,
                                device=device)
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"],
                                       params["lm_head"], *params["layers"].values()])
    print(f"model: {n_params / 1e6:.1f} M params on {device}")
    data = batches(train_data, args.batch, args.seq, args.steps)
    params, losses = train_steps(params, cfg, data, lr=args.lr, steps=args.steps,
                                 chunk=args.chunk, remat=args.remat)
    os.makedirs(args.out, exist_ok=True)
    save_fixture(params, cfg, eval_data, losses, args)
    print(f"saved fixture to {args.out}")


if __name__ == "__main__":
    main()
