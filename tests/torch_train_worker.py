"""One rank of tests/test_torch_train_sharded.py's sharded train steps.

Run as ``python torch_train_worker.py RANK WORLD INIT_FILE INPUTS OUTPUT``:
it joins a gloo group of WORLD ranks through the ``file://`` store
INIT_FILE, reads the cases' trees (numpy, as
`metalchat_tpu_torch.convert.params_from_numpy` takes them), configs and
batches from the pickle INPUTS, runs every case whose mesh this launch
holds and pickles {case: result} to OUTPUT. Eight ranks make the
(dp 2, tp 4) mesh and, on the quads {0-3} and {4-7}, tp 4 alone; four ranks
make (dp 2, tp 2) and, on the pairs {0, 1} and {2, 3}, tp 2 alone. It
imports torch, numpy and the port only.
"""

import functools
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import metalchat_tpu_torch.config as tconfig  # noqa: E402
from metalchat_tpu_torch import train as tt  # noqa: E402
from metalchat_tpu_torch.cache import KVCache  # noqa: E402
from metalchat_tpu_torch.convert import optimizer_state_leaves, params_from_numpy  # noqa: E402
from metalchat_tpu_torch.models.transformer import forward  # noqa: E402
from metalchat_tpu_torch.parallel import (  # noqa: E402
    gather_leaf,
    initialize,
    make_mesh,
    shard_cache,
    shard_params,
    shutdown,
    spmd_forward_fn,
)

CPU = torch.device("cpu")
OPTIMIZERS = {"sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2),
              "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
              "adam": lambda ps: torch.optim.Adam(ps, lr=5e-3)}
PREDICATES = {"full": tt.trainable_full, "lora": tt.trainable_lora}


def _cfg(entry):
    kind, fields = entry
    return getattr(tconfig, kind)(**fields)


def loss_fn(case):
    """``causal_lm_loss`` with the case's ``moe_aux_weight`` (key "aux"), or
    None (the step's default loss) without one."""
    aux = case.get("aux")
    return None if not aux else functools.partial(tt.causal_lm_loss, moe_aux_weight=aux)


def _counts(mesh, before):
    return {k: v - before.get(k, 0) for k, v in mesh.counts.items() if v != before.get(k, 0)}


def run_steps(case, mesh):
    """``case``'s steps on ``mesh``: every step's metrics (as float bits, to
    be held equal across ranks), the first step's gradients and
    collectives, the final leaves and optimizer moments gathered whole; the
    state."""
    cfg = _cfg(case["cfg"])
    params = shard_params(params_from_numpy(case["tree"], CPU), cfg, mesh)
    trainable, frozen, spec = tt.partition(params, PREDICATES[case["pred"]])
    init, step = tt.make_train_step(cfg, OPTIMIZERS[case["opt"]], spec, mesh=mesh,
                                    loss_fn=loss_fn(case))
    state = init(trainable)
    metrics, grads = [], None
    for batch in case["batches"]:
        before = dict(mesh.counts)
        state, m = step(state, frozen, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            counts = _counts(mesh, before)
            grads = [gather_leaf(p.grad, path, cfg, mesh).numpy().copy()
                     for p, path in zip(state.trainable, state.layout.paths)]
    whole = tt.gather_train_state(state)
    return state, (frozen, step), {
        "metrics": metrics, "grads": grads, "collectives": counts,
        "leaves": [t.detach().numpy().copy() for t in whole.trainable],
        "moments": [m.numpy().copy()
                    for m in optimizer_state_leaves(whole.opt_state, whole.trainable)],
        "local_shapes": [tuple(t.shape) for t in state.trainable]}


def run_save(case, mesh, state, frozen, step):
    """``state`` saved (the whole file, rank 0 writing), loaded into a fresh
    sharded template: the local leaves and moments bit-equal to the saved
    state's, and one more step from each bit-equal."""
    cfg = _cfg(case["cfg"])
    tt.save_train_state(case["path"], state)
    params = shard_params(params_from_numpy(case["tree"], CPU), cfg, mesh)
    trainable, _, spec = tt.partition(params, PREDICATES[case["pred"]])
    init, _ = tt.make_train_step(cfg, OPTIMIZERS[case["opt"]], spec, mesh=mesh,
                                 loss_fn=loss_fn(case))
    restored = tt.load_train_state(case["path"], init(trainable))
    same = all(torch.equal(a, b) for a, b in zip(restored.trainable, state.trainable))
    same_moments = all(torch.equal(a, b) for a, b in zip(
        optimizer_state_leaves(restored.opt_state, restored.trainable),
        optimizer_state_leaves(state.opt_state, state.trainable)))
    batch = case["batches"][0]
    s1, m1 = step(state, frozen, batch)
    s2, m2 = step(restored, frozen, batch)
    return {"same_leaves": same, "same_moments": same_moments,
            "step": int(restored.step),
            "resume_equal": float(m1["loss"]) == float(m2["loss"]) and all(
                torch.equal(a, b) for a, b in zip(s1.trainable, s2.trainable)),
            "next_loss": float(m1["loss"])}


def run_inference(case, mesh):
    """``forward(..., tp=mesh)`` (the layer route, kv-heads whole) over the
    prompt, then one token at a time: every call's f32 logits, the route
    `spmd_forward_fn` picks, the collectives."""
    cfg = _cfg(case["cfg"])
    params = shard_params(params_from_numpy(case["tree"], CPU), cfg, mesh)
    cache = shard_cache(KVCache.create(cfg, 1, cfg.max_seq_len, dtype=torch.float32,
                                       device=CPU), mesh)
    fwd = spmd_forward_fn(params, cfg, mesh)
    before = dict(mesh.counts)
    logits = []
    pos = 0
    for tokens in case["windows"]:
        out, cache = forward(params, cache, torch.tensor(tokens), pos, cfg, tp=mesh)
        logits.append(out.numpy().copy())
        pos += len(tokens[0])
    return {"logits": logits, "route": fwd.__qualname__.split(".")[0],
            "collectives": _counts(mesh, before),
            "cache_heads": int(cache.k.shape[2])}


def main(argv) -> int:
    rank, world, init_file, inputs, output = (int(argv[1]), int(argv[2]), argv[3], argv[4],
                                              argv[5])
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
               timeout_s=120)
    try:
        with open(inputs, "rb") as f:
            data = pickle.load(f)[world]
        tp = world // 2
        mesh = make_mesh(tp=tp, dp=2)
        # tp alone on the halves of the world (every rank makes every group)
        halves = [dist.new_group(list(range(h * tp, (h + 1) * tp))) for h in range(2)]
        alone = make_mesh(tp=tp, group=halves[rank // tp])
        out = {}
        with torch.no_grad():
            for name, case in data.items():
                on = mesh if case["mesh"] == "dp" else alone
                if case["kind"] == "train":
                    state, (frozen, step), out[name] = run_steps(case, on)
                    if "path" in case:
                        out[name]["save"] = run_save(case, on, state, frozen, step)
                else:
                    out[name] = run_inference(case, on)
        with open(output, "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()
    print(f"OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
