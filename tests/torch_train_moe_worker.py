"""One rank of tests/test_torch_train_moe_sharded.py's MoE train steps.

Run as ``python torch_train_moe_worker.py RANK WORLD INIT_FILE INPUTS
OUTPUT``: it joins a gloo group of WORLD ranks through the ``file://`` store
INIT_FILE, builds every mesh its cases name (``{"dp": .., "ep": .., "tp":
..}``, in the cases' order, which is every rank's), runs each case's steps
(`torch_train_worker.run_steps`, then `run_save` where the case has a
"path") and pickles {case: result} to OUTPUT. Each result also holds the
first step's routing slots a layer (``slots``: `models.moe.dispatch_slots`'
(slot, kept) of the forward's first call a layer, this dp row's tokens in
the whole batch's order). It imports torch, numpy and the port only.
"""

import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import torch_train_worker as base  # noqa: E402
from metalchat_tpu_torch.models import moe  # noqa: E402
from metalchat_tpu_torch.parallel import initialize, make_mesh, shutdown  # noqa: E402


def main(argv) -> int:
    rank, world, init_file, inputs, output = (int(argv[1]), int(argv[2]), argv[3], argv[4],
                                              argv[5])
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu",
               timeout_s=120)
    try:
        with open(inputs, "rb") as f:
            data = pickle.load(f)[world]
        meshes = {}
        for case in data.values():  # every rank makes every group, in one order
            key = tuple(sorted(case["mesh"].items()))
            if key not in meshes:
                meshes[key] = make_mesh(**case["mesh"])
        calls = []
        plain = moe.dispatch_slots

        def recorded(*args, **kw):
            out = plain(*args, **kw)
            calls.append(tuple(t.numpy().copy() for t in out))
            return out

        moe.dispatch_slots = recorded
        out = {}
        with torch.no_grad():
            for name, case in data.items():
                mesh = meshes[tuple(sorted(case["mesh"].items()))]
                calls.clear()
                state, (frozen, step), out[name] = base.run_steps(case, mesh)
                # the first step's forward: one call a layer (a dense scheme makes none)
                out[name]["slots"] = calls[:case["layers"]]
                if "path" in case:
                    out[name]["save"] = base.run_save(case, mesh, state, frozen, step)
        with open(output, "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()
    print(f"OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
