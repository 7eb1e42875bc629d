"""Temporal sharding of one video's frames over ranks (counterpart of
`sam_pt_tpu/parallel/temporal.py`).

The scale-out for one long video: the frames are split over a mesh axis,
each rank runs its contiguous block of frames, and the outputs are
gathered along time. TapNet's backbone, cost volume and heads are
frame-local except the Temporal Shift Module's one-frame coupling, which
becomes a ring halo exchange (`comm.ring_halo`); TAPIR's adds the PIPs
mixer's kernel-3 depthwise time convolutions, which run over ring-halo
padded shards. Query features are sampled on the rank that owns the query
frame and combined with a masked `psum`; query frames are pinned by
global frame id. The sharded program computes the unsharded model's
numbers, frame for frame.

The video is padded with zero frames to a multiple of the axis size; the
models mask the padding where it would reach a real frame (`TimeShard`),
and the pad frames' outputs are cropped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .comm import all_gather_cat
from .mesh import Mesh


@dataclass(frozen=True)
class TimeShard:
    """This rank's block of a video's frames: frames [index * t_local,
    (index + 1) * t_local) of `t_valid` real ones, over `size` ranks of
    `group`."""

    group: Optional[dist.ProcessGroup]
    index: int
    size: int
    t_local: int
    t_valid: int

    def frame_ids(self, device) -> torch.Tensor:
        """The global ids of this rank's frames."""
        start = self.index * self.t_local
        return torch.arange(start, start + self.t_local, device=device)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The ranks' blocks of `x` along `dim` (time), the pad frames
        cropped."""
        out = all_gather_cat(x, dim, self.group)
        return out.narrow(dim, 0, self.t_valid)


def shard_frames(video: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """(this rank's frames of `video` [T, ...], zero-padded to a multiple
    of the axis size, and its `TimeShard`)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    t = video.shape[0]
    t_local = -(-t // n)
    if t_local * n != t:
        pad = [0, 0] * (video.dim() - 1) + [0, t_local * n - t]
        video = F.pad(video, pad)
    shard = TimeShard(mesh.group(axis), i, n, t_local, t)
    return video[i * t_local:(i + 1) * t_local], shard


def _forward_time_sharded(model, video: torch.Tensor,
                          query_points: torch.Tensor, mesh: Mesh, axis: str,
                          out_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    local, shard = shard_frames(video, mesh, axis)
    out = model(local, query_points, time_shard=shard)
    return {k: shard.gather(out[k]) for k in out_keys}


def tapnet_forward_time_sharded(model, video: torch.Tensor,
                                query_points: torch.Tensor, mesh: Mesh,
                                axis: str = "data"
                                ) -> Dict[str, torch.Tensor]:
    """A `TAPNet` forward with frames sharded over `mesh[axis]` (every
    rank of the axis calls it with the same arguments). video [T, 256,
    256, 3] in [-1, 1]; query_points [N, 3] (t, y, x) raster. Returns
    dict(tracks [N, T, 2], occlusion [N, T]) on every rank."""
    return _forward_time_sharded(model, video, query_points, mesh, axis,
                                 ("tracks", "occlusion"))


def tapir_forward_time_sharded(model, video: torch.Tensor,
                               query_points: torch.Tensor, mesh: Mesh,
                               axis: str = "data"
                               ) -> Dict[str, torch.Tensor]:
    """A `TAPIR` forward with frames sharded over `mesh[axis]`, as
    `tapnet_forward_time_sharded`; also expected_dist [N, T]."""
    return _forward_time_sharded(model, video, query_points, mesh, axis,
                                 ("tracks", "occlusion", "expected_dist"))
