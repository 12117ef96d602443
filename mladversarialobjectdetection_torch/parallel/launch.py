"""Start N ranks of a new process group in fresh processes and join them.

`spawn(fn, world_size, args, init_method=...)` runs `fn(rank, *args)` in
`world_size` spawned processes that have joined one process group, and waits
for all of them until `timeout_s`: a rank that fails or hangs stops the
others, and `spawn` raises. `fn` must be importable by the children (a
module-level function), and passes its results back through files. The
multi-process tests and the card script's two-rank checks run through it;
torchrun starts a driver's ranks instead (`parallel.initialize`).
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn: Callable, rank: int, world_size: int, init_method: str,
               backend: str, timeout_s: float, threads: Optional[int],
               args: Sequence) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (), *,
          init_method: str, backend: str = "gloo", timeout_s: float = 300.0,
          threads: Optional[int] = None) -> None:
    """Run `fn(rank, *args)` on ranks 0..world_size-1 of a group joined
    through `init_method` (`file://<path>` or `tcp://localhost:<port>`).

    `threads` sets each rank's torch intra-op threads. Raises RuntimeError
    when a rank exits with an error or the ranks have not all finished
    within `timeout_s` seconds; every rank is stopped before it returns."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, backend,
                               timeout_s, threads, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                failure = (f"rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
                break
            if time.monotonic() > deadline:
                failure = f"the ranks did not finish within {timeout_s} s"
                break
            procs[0].join(timeout=0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failure = (f"rank {bad[0]} exited with code "
                           f"{procs[bad[0]].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if failure:
        raise RuntimeError(f"spawn of {world_size} ranks of "
                           f"{getattr(fn, '__name__', fn)}: {failure}")
