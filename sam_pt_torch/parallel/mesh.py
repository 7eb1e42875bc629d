"""Process meshes over `torch.distributed` (counterpart of
`sam_pt_tpu/parallel/mesh.py`).

The JAX package is one process driving a mesh of chips; the port runs one
process per rank, PyTorch's idiom, and every rank runs the same program
on its part of the data with its collectives on process groups
(`parallel/comm.py`). A `Mesh` lays the world's ranks out as a grid with
named axes (`data`, and `model` for tensor parallelism) and holds one
process group per axis: the ranks that share this rank's coordinates on
every other axis.

Parameters are replicated by construction: every rank builds the same
weights from the same seed, or loads the same file (`replicate` is the
identity). Batches are split along their leading axis with no implicit
padding (`shard_batch`); callers pad or chunk to a multiple of the axis
size first, as the JAX package's do.

On one card several ranks can share the GPU over the gloo backend (NCCL
takes one rank per card); on a host with several cards each rank takes
`cuda:LOCAL_RANK`.
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_map
from .comm import all_gather_cat, group_rank, group_size


def init_world(backend: str = "nccl", *, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               device: Optional[str] = None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=10)
               ) -> torch.device:
    """Join the process group and return this rank's device.

    Without `init_method` the group is the one `torchrun` describes
    (`MASTER_ADDR`, `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK` in
    the environment); with it (`tcp://host:port`, `file:///path`),
    `rank` and `world_size` must be given. The device is
    `cuda:LOCAL_RANK % device_count` (LOCAL_RANK defaults to the rank),
    or `device` where the caller names one (`"cpu"`, `"cuda:0"`). NCCL
    takes one rank per card: asking for it with more ranks on this host
    than cards raises; several ranks share a card over `gloo`. A process
    already in a group keeps it."""
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU")
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl" and (device.type != "cuda" or local_world
                              > torch.cuda.device_count()):
        raise ValueError(
            f"nccl takes one rank per CUDA card: {local_world} ranks on "
            f"{device.type} with {torch.cuda.device_count()} card(s) on this "
            f"host; use backend='gloo' for ranks that share a card or the "
            f"CPU")
    if not dist.is_initialized():
        kwargs = {"timeout": timeout}
        if init_method is not None:
            kwargs.update(init_method=init_method, rank=rank,
                          world_size=world_size)
        dist.init_process_group(backend, **kwargs)
    return device


def join_launched_world(backend: str, device: str = "cuda") -> bool:
    """Join the group of a launcher that describes one (`torchrun`:
    WORLD_SIZE > 1 in the environment) over `backend`, this rank on
    `cuda:LOCAL_RANK` (or on the CPU for `device` "cpu"). Returns whether
    the process is in a group of several ranks."""
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return False
    init_world(backend, device="cpu" if str(device) == "cpu" else None)
    return True


@dataclass
class Mesh:
    """This rank's view of a grid of ranks with named axes.

    `shape` maps each axis to its size (the JAX mesh's `shape`), `coords`
    to this rank's index along it, and `groups` to the process group of
    the ranks that differ from this one along that axis only (None for
    the default group, or outside a process group in a world of one)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(repr=False)

    @property
    def size(self) -> int:
        """Ranks in the mesh (the JAX mesh's `devices.size`)."""
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def create_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The world's ranks as a grid of `shape` (default: every rank along
    the first axis), row-major, the last axis varying fastest, so that a
    `model` axis after `data` groups neighbouring ranks. Every rank of the
    world must call it, in the same order as its other groups: it creates
    one process group for each row and column. Outside a process group it
    is a mesh of one rank."""
    axis_names = tuple(axis_names)
    world = group_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {' x '.join(map(str, shape))} ({' x '.join(axis_names)}) "
            f"needs {math.prod(shape)} ranks, and the world has {world}: "
            f"every rank must belong to the mesh")
    rank = group_rank()
    coords, rest = {}, rank
    for name, size in zip(reversed(axis_names), reversed(shape)):
        coords[name] = rest % size
        rest //= size
    coords = {name: coords[name] for name in axis_names}
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ai, name in enumerate(axis_names):
        if shape[ai] == world or not dist.is_initialized():
            groups[name] = None  # the default group spans the axis
            continue
        stride = math.prod(shape[ai + 1:])
        mine = None
        # every line of ranks along this axis, in one order on every rank
        for start in range(world):
            if (start // stride) % shape[ai]:
                continue  # not the first rank of a line along this axis
            ranks = [start + k * stride for k in range(shape[ai])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        groups[name] = mine
    return Mesh(axis_names, dict(zip(axis_names, shape)), coords, groups)


def check_mesh(mesh) -> None:
    """Raise TypeError unless `mesh` is None or a `Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                        f"{type(mesh).__name__}")


class BatchSharding:
    """A batch split along its leading axis over a mesh axis: `shard` takes
    this rank's contiguous slice, `gather` concatenates every rank's
    result in rank order (the JAX package's `NamedSharding(mesh,
    P(axis))` as an input and an output sharding)."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.group = mesh.group(axis)

    def shard(self, x):
        return tree_map(self._slice, x)

    def gather(self, x):
        return tree_map(lambda a: all_gather_cat(a, 0, self.group), x)

    def _slice(self, a: torch.Tensor) -> torch.Tensor:
        b = a.shape[0]
        if b % self.size:
            raise ValueError(
                f"a batch of {b} does not split over {self.size} ranks of "
                f"mesh axis {self.axis!r}: pad it to a multiple first")
        n = b // self.size
        return a[self.index * n:(self.index + 1) * n]


def batch_sharding(mesh: Mesh, axis: str = "data") -> BatchSharding:
    """The sharding of a batch's leading axis over `axis`."""
    return BatchSharding(mesh, axis)


def replicate(tree, mesh: Mesh):
    """Parameters on every rank of `mesh`: they already are, since every
    rank builds the same weights from the same seed or loads the same
    file. The identity."""
    return tree


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous slice of `x` (a tensor or a dict of them)
    along the leading axis, which must be a multiple of the axis size."""
    return batch_sharding(mesh, axis).shard(x)
