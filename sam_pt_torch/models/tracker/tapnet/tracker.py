"""TapNet point tracker (counterpart of
`sam_pt_tpu/models/tracker/tapnet/tracker.py`): TAPIR's input preparation
and query conversion, `query_chunk_size` (16) queries at a time, a point
visible where 1 - sigmoid(occlusion) exceeds `visibility_threshold` (0.5).
The feature grid is computed once per video tensor and kept for the next
call with the same tensor. `time_parallel` splits the video's frames over
a mesh's `data` axis, as TAPIR's tracker does.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ....parallel.mesh import check_mesh
from ....utils.checkpoint import load_or_randomize_, load_tapnet_checkpoint
from ...batch_norm import reset_batch_norm_stats_
from ..api import PointTracker
from ..tapir.tracker import (not_occluded, prepare_frames, raster_queries,
                             time_shard_video, to_frame, track_in_chunks)
from .model import TAPNet


class TapNetPointTracker(PointTracker):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 visibility_threshold: float = 0.5,
                 query_chunk_size: int = 16,
                 allow_random_init: bool = False,
                 time_parallel: bool = False, mesh=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        check_mesh(mesh)
        self.time_parallel = time_parallel
        self.mesh = mesh
        self.visibility_threshold = visibility_threshold
        self.query_chunk_size = query_chunk_size
        self.model = TAPNet()
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            load_tapnet_checkpoint(checkpoint_path, self.model.to(device))
        elif not load_or_randomize_(self.model, checkpoint_path,
                                    allow_random_init=allow_random_init,
                                    seed=seed, device=device):
            reset_batch_norm_stats_(self.model)
        self.model.eval().requires_grad_(False)

    def _features(self, rgbs: torch.Tensor):
        """The video's feature grid (time-sharded: of this rank's frames)
        and its `TimeShard` (None unsharded), once per video tensor."""
        def compute():
            frames, shard = time_shard_video(self, rgbs[0])
            return (self.model.get_feature_grid(prepare_frames(frames),
                                                shard), shard)

        return self.per_video(rgbs, compute)

    def _grid(self, rgbs: torch.Tensor) -> torch.Tensor:
        return self._features(rgbs)[0]

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("TapNet tracks one video at a time")
        t, h, w, _ = rgbs.shape[1:]
        grid, shard = self._features(rgbs)
        q = torch.as_tensor(raster_queries(
            np.asarray(query_points, np.float32)[0], h, w),
            device=rgbs.device)
        tracks, occ = track_in_chunks(self.model.track, grid, q,
                                      self.query_chunk_size, shard,
                                      ("tracks", "occlusion"))
        visible = not_occluded(occ) > self.visibility_threshold
        return (to_frame(tracks, h, w).transpose(0, 1)[None],
                visible.T.float()[None])
