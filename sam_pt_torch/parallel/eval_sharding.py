"""Evaluation sharding over processes (counterpart of
`sam_pt_tpu/parallel/eval_sharding.py`).

In one process both functions are the identity. Sharding videos over
several GPUs (`torch.distributed` with a world size above 1) is not ported
yet (ROADMAP §1 item 8): both raise rather than return one process's part
of the results as if it were the whole.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch.distributed as dist


def world_size() -> int:
    """Processes of the initialised `torch.distributed` group, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the initialised group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _single_process(what: str) -> None:
    if world_size() > 1:
        raise NotImplementedError(
            f"{what} over {world_size()} processes: multi-GPU VIS is not "
            f"ported yet (ROADMAP §1 item 8)")


def shard_videos_across_hosts(items: Sequence[Any]) -> List[Any]:
    """This process's part of the work list: all of it."""
    _single_process("sharding the videos")
    return list(items)


def gather_host_results(records: List[Any]) -> List[Any]:
    """Every process's records: this one's."""
    _single_process("gathering the records")
    return list(records)
