#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, with two ranks sharing
one card (the port's rank meshes on a one-card host: ``launch/mesh.py``).

    PYTHONPATH=src python3 scripts/gloo_cuda_probe.py [--cpu]

Each rank calls ``all_reduce``, ``all_gather``, ``reduce_scatter_tensor``
and ``all_to_all_single`` on f32 tensors on ``cuda:0`` over a gloo group
and checks the result; rank 0 prints one line a collective: ``ok``, or
the error gloo raised. ``--cpu`` runs the same on CPU tensors.
"""
from __future__ import annotations

import socket
import sys
import traceback

WORLD = 2


def _rank(rank, port, dev, out):
    import datetime

    import torch
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=rank, world_size=WORLD,
                             timeout=datetime.timedelta(seconds=60))
    res = {}
    try:
        x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank

        def all_reduce():
            y = x.clone()
            tdist.all_reduce(y)
            return torch.equal(y.cpu(), 2 * torch.arange(8.) + 10)

        def all_gather():
            parts = [torch.empty_like(x) for _ in range(WORLD)]
            tdist.all_gather(parts, x)
            return torch.equal(torch.cat(parts).cpu(), torch.cat(
                [torch.arange(8.), torch.arange(8.) + 10]))

        def reduce_scatter_tensor():
            y = torch.empty(8 // WORLD, dtype=x.dtype, device=dev)
            tdist.reduce_scatter_tensor(y, x)
            want = (2 * torch.arange(8.) + 10)[rank * 4:(rank + 1) * 4]
            return torch.equal(y.cpu(), want)

        def all_to_all_single():
            y = torch.empty_like(x)
            tdist.all_to_all_single(y, x)
            return y.shape == x.shape

        for fn in (all_reduce, all_gather, reduce_scatter_tensor,
                   all_to_all_single):
            try:
                res[fn.__name__] = "ok" if fn() else "wrong result"
            except Exception as e:     # noqa: BLE001 — the probe's answer
                res[fn.__name__] = f"{type(e).__name__}: {e}".splitlines()[0]
        if rank == 0:
            out.put(res)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        tdist.destroy_process_group()


def main(argv=None):
    import torch
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    dev = "cpu" if "--cpu" in argv else "cuda:0"
    if dev != "cpu" and not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device (pass --cpu to rehearse)",
              file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank, args=(r, port, dev, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    if any(p.exitcode != 0 for p in procs) or out.empty():
        print("gloo_cuda_probe: a rank failed", file=sys.stderr)
        return 1
    print(f"[gloo] torch {torch.__version__} on {dev}, {WORLD} ranks:")
    for name, verdict in out.get().items():
        print(f"[gloo] {name}: {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
