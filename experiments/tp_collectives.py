"""What the collectives of phase tp cost: two ranks on one card over gloo
(`chip_smoke.TP_BACKEND`), each collective at the shapes the 8B's
tensor-parallel path gives it, timed on the host clock over 20 calls after
one warm-up call, each ending in ``synchronize``:

* ``all_reduce`` sum of the row-parallel partial sums after wo and w2 and of
  the embedding, bf16 ``[rows, 4096]`` at one row (the generate step) and 8
  (the serve step);
* ``all_reduce`` max of a prefill's per-token absmax, f32 ``[512, 1]``, and
  sum of its exact int32 products, ``[512, 4096]`` (one 512-token prompt)
  and ``[2048, 4096]`` (8 chunks of 256);
* ``all_gather`` of the logits' vocabulary halves, f32 ``[rows, 64128]``.

Prints each time per call on its own line beside the card's name and power
limit. Run on a machine with an H100 from the repository root:
``python3 experiments/tp_collectives.py``.
"""
import subprocess
import sys
import tempfile
import time

import torch
import torch.multiprocessing as mp

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

H, V_LOCAL, CALLS = 4096, 128256 // cs.TP_RANKS, 20
CASES = [("all_reduce sum", (1, H), torch.bfloat16), ("all_reduce sum", (8, H), torch.bfloat16),
         ("all_reduce max", (512, 1), torch.float32), ("all_reduce sum", (512, H), torch.int32),
         ("all_reduce sum", (2048, H), torch.int32), ("all_gather", (1, V_LOCAL), torch.float32),
         ("all_gather", (8, V_LOCAL), torch.float32)]


def rank_main(rank: int, store: str) -> None:
    from metalchat_tpu_torch.parallel import initialize, make_mesh, shutdown

    initialize(f"file://{store}", cs.TP_RANKS, rank, backend=cs.TP_BACKEND)
    try:
        mesh = make_mesh()
        for what, shape, dtype in CASES:
            x = torch.ones(shape, dtype=dtype, device="cuda")

            def call():
                if what == "all_gather":
                    return mesh.all_gather(x)
                return mesh.all_reduce(x.clone(), what.split()[1])

            call()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / CALLS
            if rank == 0:
                print(f"{what} {list(shape)} {str(dtype).removeprefix('torch.')}: "
                      f"{ms:.4f} ms a call ({cs.TP_RANKS} ranks over {cs.TP_BACKEND} on "
                      "one card)", flush=True)
    finally:
        shutdown()


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(f"{tmp}/store",), nprocs=cs.TP_RANKS)


if __name__ == "__main__":
    main()
