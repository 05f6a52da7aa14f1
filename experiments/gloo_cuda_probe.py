"""A probe of the card's machine: Python, torch and CUDA versions; the CPU's
int32 ``@`` of int8 operands against ``torch._int_mm`` at 96 × 4096 ×
14336 (one call each, and whether both give the same int32s); then two ranks
on the one card over gloo, which first ``send`` a CUDA tensor and, after
that, would try host tensors, ``batch_isend_irecv``, collectives on CUDA
tensors and the time of a 4 MB and an 8 KB hand-off through the host.

On an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128 the CUDA ``send`` does
not raise: gloo writes the device pointer (``writev ... Bad address``), the
connection breaks and both ranks exit 1, so nothing after it runs. That is
why `parallel.mesh.GridMesh` stages CUDA tensors through the host on gloo.
Run on a machine with an H100 from the repository root:
``python3 experiments/gloo_cuda_probe.py``."""
import os
import sys
import time
import multiprocessing as mp


def rank_main(rank, store):
    import torch
    import torch.distributed as dist
    import datetime
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda")
    t = torch.full((4, 1024), float(rank + 1), device=dev)
    out = {}
    # blocking send/recv with a CUDA tensor
    try:
        if rank == 0:
            dist.send(t, dst=1)
        else:
            r = torch.empty_like(t)
            dist.recv(r, src=0)
            out["send_cuda"] = float(r[0, 0])
    except Exception as e:  # noqa: BLE001
        out["send_cuda"] = f"ERR {type(e).__name__}: {str(e)[:200]}"
    dist.barrier()
    # CPU staging
    c = t.cpu()
    if rank == 0:
        dist.send(c, dst=1)
    else:
        r = torch.empty_like(c)
        dist.recv(r, src=0)
        out["send_cpu"] = float(r[0, 0])
    # ring via isend/irecv on CPU
    r = torch.empty_like(c)
    req = dist.isend(c, dst=1 - rank)
    dist.recv(r, src=1 - rank)
    req.wait()
    out["ring_isend"] = float(r[0, 0])
    try:
        r2 = torch.empty_like(c)
        ops = [dist.P2POp(dist.isend, c, 1 - rank), dist.P2POp(dist.irecv, r2, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out["batch_p2p"] = float(r2[0, 0])
    except Exception as e:  # noqa: BLE001
        out["batch_p2p"] = f"ERR {type(e).__name__}: {str(e)[:200]}"
    # collectives with CUDA tensors over gloo
    for name, fn in (("broadcast", lambda x: dist.broadcast(x, src=1)),
                     ("all_reduce", lambda x: dist.all_reduce(x))):
        x = t.clone()
        try:
            fn(x)
            out[name] = float(x[0, 0])
        except Exception as e:  # noqa: BLE001
            out[name] = f"ERR {type(e).__name__}: {str(e)[:200]}"
    parts = [torch.empty_like(t) for _ in range(2)]
    try:
        dist.all_gather(parts, t)
        out["all_gather"] = [float(p[0, 0]) for p in parts]
    except Exception as e:  # noqa: BLE001
        out["all_gather"] = f"ERR {type(e).__name__}: {str(e)[:200]}"
    # timing: a 4 MB hand-off through the host, 20 times
    big = torch.randn(1, 512, 4096, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        if rank == 0:
            dist.send(big.cpu(), dst=1)
        else:
            rb = torch.empty(big.shape, dtype=big.dtype)
            dist.recv(rb, src=0)
            big.copy_(rb)
    torch.cuda.synchronize()
    out["handoff_4MB_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    small = torch.randn(1, 1, 4096, device=dev).to(torch.bfloat16)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(50):
        if rank == 0:
            dist.send(small.cpu(), dst=1)
        else:
            rb = torch.empty(small.shape, dtype=small.dtype)
            dist.recv(rb, src=0)
            small.copy_(rb)
    torch.cuda.synchronize()
    out["handoff_8KB_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    print(f"rank {rank}: {out}", flush=True)
    dist.destroy_process_group()


def main():
    import torch
    print(sys.version, torch.__version__, torch.version.cuda, torch.get_num_threads(),
          os.cpu_count(), flush=True)
    a = torch.randint(-127, 128, (96, 4096), dtype=torch.int8)
    b = torch.randint(-127, 128, (14336, 4096), dtype=torch.int8)
    t = time.perf_counter()
    r1 = a.int() @ b.int().T
    print("cpu int32 matmul 96x4096x14336", time.perf_counter() - t, flush=True)
    try:
        t = time.perf_counter()
        r2 = torch._int_mm(a, b.t())
        print("cpu _int_mm", time.perf_counter() - t, torch.equal(r1, r2), flush=True)
        for m, k, n in [(1, 64, 3), (2, 33, 5), (5, 7, 1)]:
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8)
            y = torch.randint(-128, 128, (n, k), dtype=torch.int8)
            print("  _int_mm", m, k, n, torch.equal(torch._int_mm(x, y.t()), x.int() @ y.int().T))
    except Exception as e:  # noqa: BLE001
        print("cpu _int_mm ERR", type(e).__name__, e, flush=True)
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        ps = [ctx.Process(target=rank_main, args=(r, f"{tmp}/store")) for r in range(2)]
        for p in ps:
            p.start()
        for p in ps:
            p.join(120)
        for p in ps:
            if p.is_alive():
                p.kill()
        print("exit codes", [p.exitcode for p in ps], flush=True)


if __name__ == "__main__":
    main()
