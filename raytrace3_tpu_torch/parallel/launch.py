"""Run one function on every rank of a fresh process group.

``spawn(fn, world, args)`` starts ``world`` processes with
``torch.multiprocessing`` (the spawn method), joins them into a process
group on a free localhost port and calls ``fn(*args)`` on each; it returns
the ranks' results in rank order.  A rank that raises fails the call, and
a call that outlives ``timeout`` has its processes terminated and raises
``TimeoutError``, so a rank that hangs in a collective cannot stall the
caller.  ``torchrun`` does the same for the CLI; this is for tests, the
dry run and ``chip_smoke.py``, which need the results back.
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, threads, fn, args, queue):
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, timeout=timedelta(minutes=10))
    try:
        queue.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, backend: str, timeout: float = 120.0,
          threads: int = 1) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each rank a process
    in a ``backend`` group, which the caller names: "nccl" for ranks on
    cards, one a card; "gloo" for CPU ranks, or for ranks that share a card
    and then stage every collective through host memory (``parallel.mesh``).
    ``fn`` and ``args`` must pickle.  A rank's ``LOCAL_RANK`` is its rank,
    so ``parallel.mesh.rank_device`` puts it on card ``rank % cards``.
    ``threads``: each rank's intra-op threads."""
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main, args=(world, free_port(), backend, threads, fn, args,
                                               queue),
                             nprocs=world, join=False, start_method="spawn")
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            while not queue.empty():          # drain before join: a full pipe blocks a rank
                rank, out = queue.get()
                results[rank] = out
            if ctx.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    while not queue.empty():
        rank, out = queue.get()
        results[rank] = out
    missing = sorted(set(range(world)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} of {fn.__name__} returned nothing")
    return [results[r] for r in range(world)]
