"""The collectives of the parallel layer (counterpart of the `lax.psum`,
`lax.ppermute` and the gathers at `shard_map` boundaries that the JAX
package uses), each built on `dist.all_reduce` alone.

`all_reduce` is the one tensor collective that every backend carries for
CUDA tensors: gloo, the backend that lets several ranks share one card
(NCCL refuses two ranks on one GPU), has only `all_reduce` and
`broadcast` for them. The backend is the caller's choice, made in
`init_process_group`; nothing here picks one.

`group=None` names the default group. Outside an initialised process
group every function is the identity of a world of one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks of `group` (of the default group for None); 1 outside an
    initialised process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup] = None) -> int:
    """This process's rank within `group`; 0 outside a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def psum(x: torch.Tensor,
         group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, in x's dtype, as
    `jax.lax.psum` sums (a new tensor: `x` is left as it is). A caller
    that wants a float32 sum passes float32. Two bf16 values sum to
    their float32 sum rounded to bf16; over more ranks the backend's
    ring rounds each partial sum."""
    out = x.clone()
    if dist.is_initialized():
        dist.all_reduce(out, group=group)
    return out


def ring_halo(first: torch.Tensor, last: torch.Tensor,
              group: Optional[dist.ProcessGroup] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two ring exchanges of a time-sharded convolution: rank r gets
    (rank r - 1's `last`, rank r + 1's `first`), each zero at the global
    edges (rank 0 has no left neighbour, the last rank no right one).

    One `all_reduce` of a [world, 2, ...] buffer in which each rank fills
    its own slot; the sums are exact, since every other slot is zero."""
    world, rank = group_size(group), group_rank(group)
    if first.shape != last.shape:
        raise ValueError(f"halo shapes differ: {tuple(first.shape)} and "
                         f"{tuple(last.shape)}")
    buf = first.new_zeros((world, 2, *first.shape))
    buf[rank, 0] = first
    buf[rank, 1] = last
    if dist.is_initialized():
        dist.all_reduce(buf, group=group)
    zeros = torch.zeros_like(first)
    from_left = buf[rank - 1, 1] if rank > 0 else zeros
    from_right = buf[rank + 1, 0] if rank < world - 1 else zeros
    return from_left, from_right


def all_gather_cat(x: torch.Tensor, dim: int = 0,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order; every rank
    gets the whole. The parts may differ in size along `dim` only.

    Each rank writes its part's bytes into its own zero-padded slot of a
    [world, max bytes] buffer, viewed as int32 where every size is a
    multiple of 4 bytes and as uint8 otherwise, and the buffer is summed:
    exact for any dtype (-0.0, -inf, NaN payloads and bf16 bits come back
    as they were), whatever float dtypes the backend reduces."""
    if not dist.is_initialized():
        return x
    world, rank = group_size(group), group_rank(group)
    dim = dim % x.dim()
    sizes = torch.zeros(world, dtype=torch.int32, device=x.device)
    sizes[rank] = x.shape[dim]
    dist.all_reduce(sizes, group=group)
    sizes = sizes.tolist()
    part = x.movedim(dim, 0).contiguous()
    row_bytes = part.shape[1:].numel() * part.element_size()
    nbytes = [s * row_bytes for s in sizes]
    word = torch.int32 if all(n % 4 == 0 for n in nbytes) else torch.uint8
    width = max(nbytes) // (4 if word == torch.int32 else 1)
    buf = torch.zeros((world, width), dtype=word, device=x.device)
    if part.numel():
        buf[rank, :nbytes[rank] // buf.element_size()] = (
            part.reshape(-1).view(torch.uint8).view(word))
    dist.all_reduce(buf, group=group)
    parts = [buf[r, :nbytes[r] // buf.element_size()].view(torch.uint8)
             .view(x.dtype).reshape(sizes[r], *part.shape[1:])
             for r in range(world)]
    return torch.cat(parts, dim=0).movedim(0, dim)
