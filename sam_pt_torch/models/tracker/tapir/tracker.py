"""TAPIR point trackers (counterpart of
`sam_pt_tpu/models/tracker/tapir/tracker.py`).

`TapirPointTracker`: the uint8 video is resized on the device to 256 x 256
(antialiased, by the dense weight matrices) and scaled to [-1, 1]; the
(t, x, y) queries become (t, y, x) in 256-raster units; the model runs on
`query_chunk_size` queries at a time; a point is visible where
(1 - sigmoid(occlusion)) * (1 - sigmoid(expected_dist)) exceeds
`visibility_threshold`; tracks are scaled back to the frame. The feature
pyramid is computed once per video tensor and kept for the next call with
the same tensor (the orchestrator calls once per batch of masks); every
query is tracked on its own, so the chunks need no padding.

With `time_parallel`, every rank of a mesh's `data` axis (`mesh`, or a
mesh of the whole world, made at the first call) takes its block of the
video's frames and runs the model on it (`parallel/temporal.py`); the
outputs are gathered along time, so every rank returns the whole tracks.

`OnlineTapirPointTracker`: the causal model fed one frame at a time, the
query features taken once from the query frame (never sharded).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ....ops.resize import resize_bilinear
from ....parallel.mesh import check_mesh, create_mesh
from ....parallel.temporal import shard_frames
from ....utils.checkpoint import load_or_randomize_, load_tapir_checkpoint
from ..api import PointTracker
from .model import TAPIR, TRAIN_SIZE


def prepare_frames(video: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] uint8 -> [T, 256, 256, 3] float32 in [-1, 1]: an
    antialiased bilinear resize by the dense weight matrices (a tracker
    carries a last-bit difference of its input into its tracks)."""
    x = resize_bilinear(video.float(), TRAIN_SIZE, antialias=True,
                        dense=True)
    return x / 255.0 * 2.0 - 1.0


def raster_queries(query_points: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, 3] (t, x, y) pixels -> (t, y, x) in 256-raster units."""
    qp = np.asarray(query_points, np.float32)
    return np.stack([qp[:, 0], qp[:, 2] * (TRAIN_SIZE[0] / h),
                     qp[:, 1] * (TRAIN_SIZE[1] / w)], axis=-1).astype(
                         np.float32)


def to_frame(tracks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., 2] (x, y) in 256-raster units -> pixels of an h x w frame."""
    return torch.stack([tracks[..., 0] * (w / TRAIN_SIZE[1]),
                        tracks[..., 1] * (h / TRAIN_SIZE[0])], dim=-1)


def not_occluded(logits: torch.Tensor) -> torch.Tensor:
    """1 - sigmoid(logits), as the reference computes it."""
    return 1 - 1 / (1 + torch.exp(-logits))


def load_tapir_(model: TAPIR, checkpoint_path: Optional[str], *,
                allow_random_init: bool, seed: int,
                device: Union[str, torch.device]) -> None:
    """The public .npy at `checkpoint_path` through the haiku reader, or
    random weights as `load_or_randomize_` draws them."""
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        load_tapir_checkpoint(checkpoint_path, model.to(device))
    else:
        load_or_randomize_(model, checkpoint_path,
                           allow_random_init=allow_random_init, seed=seed,
                           device=device)


def time_shard_video(tracker, video: torch.Tensor):
    """(this rank's frames of `video` [T, ...] and its `TimeShard`) where
    `tracker.time_parallel` is set, over the `data` axis of its `mesh`
    (made of the whole world at the first call where None); else (video,
    None)."""
    if not tracker.time_parallel:
        return video, None
    if tracker.mesh is None:
        tracker.mesh = create_mesh()
    return shard_frames(video, tracker.mesh)


def track_in_chunks(track, features, q: torch.Tensor, chunk: int,
                    time_shard, keys) -> tuple:
    """`track(features, queries, time_shard)` over `chunk` queries at a
    time; each of `keys` concatenated over the chunks ([N, T, ...]), and,
    time-sharded, gathered along time."""
    outs = [track(features, q[i:i + chunk], time_shard)
            for i in range(0, q.shape[0], chunk)]
    cat = [torch.cat([o[k] for o in outs]) for k in keys]
    if time_shard is not None:
        cat = [time_shard.gather(x) for x in cat]
    return tuple(cat)


class TapirPointTracker(PointTracker):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 visibility_threshold: float = 0.1,
                 query_chunk_size: int = 64,
                 allow_random_init: bool = False,
                 time_parallel: bool = False, mesh=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.visibility_threshold = visibility_threshold
        self.query_chunk_size = query_chunk_size
        check_mesh(mesh)
        self.time_parallel = time_parallel
        self.mesh = mesh
        self.model = TAPIR()
        load_tapir_(self.model, checkpoint_path,
                    allow_random_init=allow_random_init, seed=seed,
                    device=device)
        self.model.eval().requires_grad_(False)

    def _features(self, rgbs: torch.Tensor):
        """The video's feature pyramid (time-sharded: of this rank's
        frames) and its `TimeShard` (None unsharded), once per video
        tensor."""
        def compute():
            frames, shard = time_shard_video(self, rgbs[0])
            return self.model.feature_pyramid(prepare_frames(frames)), shard

        return self.per_video(rgbs, compute)

    def _pyramid(self, rgbs: torch.Tensor):
        return self._features(rgbs)[0]

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("TAPIR tracks one video at a time")
        t, h, w, _ = rgbs.shape[1:]
        pyramid, shard = self._features(rgbs)
        q = torch.as_tensor(raster_queries(
            np.asarray(query_points, np.float32)[0], h, w),
            device=rgbs.device)
        tracks, occ, expd = track_in_chunks(
            self.model.track, pyramid, q, self.query_chunk_size, shard,
            ("tracks", "occlusion", "expected_dist"))
        visible = (not_occluded(occ) * not_occluded(expd)
                   > self.visibility_threshold)
        return (to_frame(tracks, h, w).transpose(0, 1)[None],
                visible.T.float()[None])


class OnlineTapirPointTracker:
    """Streaming TAPIR (causal time convs): `init_tracking` takes the query
    features from the query frame, then each `track_frame` call tracks one
    new frame with the causal context carried from the frames before."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 visibility_threshold: float = 0.1,
                 allow_random_init: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.visibility_threshold = visibility_threshold
        self.device = torch.device(device)
        self.model = TAPIR(use_causal_conv=True)
        load_tapir_(self.model, checkpoint_path,
                    allow_random_init=allow_random_init, seed=seed,
                    device=device)
        self.model.eval().requires_grad_(False)
        self._state = None
        self._queries = None
        self._hw = None

    def _prep(self, frame) -> torch.Tensor:
        frame = torch.as_tensor(frame, device=self.device)
        self._hw = tuple(frame.shape[:2])
        return prepare_frames(frame[None])

    @torch.no_grad()
    def init_tracking(self, frame, query_xy: np.ndarray) -> None:
        """frame [H, W, 3] uint8; query_xy [N, 2] (x, y) pixels."""
        h, w = frame.shape[:2]
        query_xy = np.asarray(query_xy)
        q = np.stack([np.zeros(len(query_xy)),
                      query_xy[:, 1] * (TRAIN_SIZE[0] / h),
                      query_xy[:, 0] * (TRAIN_SIZE[1] / w)],
                     axis=-1).astype(np.float32)
        self._queries = self.model.get_query_features_online(
            self._prep(frame), torch.as_tensor(q, device=self.device))
        self._state = None

    @torch.no_grad()
    def track_frame(self, frame):
        """Returns (positions [N, 2] (x, y) pixels, visible [N] bool), as
        numpy arrays."""
        if self._queries is None:
            raise RuntimeError("call init_tracking first")
        q_hi, q_lo = self._queries
        out, self._state = self.model.online_step(self._prep(frame), q_hi,
                                                  q_lo, self._state)
        h, w = self._hw
        tracks = to_frame(out["tracks"][:, 0], h, w)
        visible = (not_occluded(out["occlusion"][:, 0])
                   * not_occluded(out["expected_dist"][:, 0])
                   > self.visibility_threshold)
        return tracks.cpu().numpy(), visible.cpu().numpy()
