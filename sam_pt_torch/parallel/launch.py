"""Spawn a `torch.distributed` world on this host and collect each rank's
result: what `torchrun --nproc-per-node N` does for a script, for one
function. It is how several ranks share one card (backend `gloo`), how
the CPU runs a world (`device="cpu"`), and how a host with several cards
runs one rank per card (`nccl`).

Each rank is a fresh process (the `spawn` start method), joins the group
through its own `file://` rendezvous with a timeout, so that a rank that
hangs fails the world instead of stalling it, and runs `fn(device,
*args)`. `fn` must be a module-level function and `args` and its result
picklable (tensors on the CPU).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_world


def _rank_main(fn, rank: int, world_size: int, backend: str,
               init_method: str, device: Optional[str], args: Sequence,
               results, timeout: float) -> None:
    try:
        dev = init_world(backend, init_method=init_method, rank=rank,
                         world_size=world_size, device=device,
                         timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(dev, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable[..., Any], world_size: int, *, backend: str,
              device: Optional[str] = None, args: Sequence = (),
              timeout: float = 600.0) -> List[Any]:
    """`fn(device, *args)` on `world_size` spawned ranks; their results in
    rank order. `device` None gives rank r `cuda:r % device_count`
    (`init_world`); `"cpu"` or `"cuda:0"` puts every rank there. Raises
    with the rank's traceback if one fails, and TimeoutError if the world
    has not finished after `timeout` seconds; every rank process has ended
    when it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world_size, backend,
                                   init_method, device, tuple(args), results,
                                   timeout), daemon=True)
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        found = {}
        deadline = time.monotonic() + timeout
        try:
            while len(found) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world_size} ({backend}) not done after "
                        f"{timeout:.0f} s; ranks done: {sorted(found)}")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in found]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world_size} exited with "
                            f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"({backend}) failed:\n{payload}")
                found[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [found[r] for r in range(world_size)]
