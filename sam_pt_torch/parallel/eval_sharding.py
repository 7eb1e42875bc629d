"""Evaluation sharding over processes (counterpart of
`sam_pt_tpu/parallel/eval_sharding.py`).

Each process of a `torch.distributed` world (`torchrun`, one rank per
card, or several ranks sharing one card over gloo) takes a strided slice
of the video list, runs it on its device, and the records are gathered to
every process, where rank 0 writes and scores them. Outside a process
group (or in a world of one) both functions are the identity.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch.distributed as dist

from .comm import group_rank, group_size


def world_size() -> int:
    """Processes of the initialised `torch.distributed` group, else 1."""
    return group_size()


def rank() -> int:
    """This process's rank in the initialised group, else 0."""
    return group_rank()


def shard_videos_across_hosts(items: Sequence[Any]) -> List[Any]:
    """This process's strided slice of the work list: items[rank::world]."""
    return list(items)[rank()::world_size()]


def gather_host_results(records: List[Any]) -> List[Any]:
    """Every process's records, in rank order, on every process.

    Pickled over `dist.all_gather_object` on a CPU (gloo) group, which
    takes payloads of unequal sizes: the default group where it is gloo,
    else a gloo group made for the call (every rank calls this)."""
    if world_size() == 1:
        return list(records)
    group = None
    if dist.get_backend() != "gloo":
        group = dist.new_group(backend="gloo")
    gathered: List[Any] = [None] * world_size()
    try:
        dist.all_gather_object(gathered, list(records), group=group)
    finally:
        if group is not None:
            dist.destroy_process_group(group)
    return [r for part in gathered for r in part]
