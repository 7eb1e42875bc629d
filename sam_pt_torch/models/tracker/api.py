"""Point tracker contract (counterpart of `sam_pt_tpu/models/tracker/api.py`).

  forward_device(rgbs, query_points) -> (trajectories, visibilities)

    rgbs:          [1, T, H, W, 3] uint8 video on the tracker's device
                   (channels-last, as in the JAX package).
    query_points:  [1, N, 3] float32 numpy (t, x, y).
    trajectories:  [1, T, N, 2] float32 tensor (x, y) per frame.
    visibilities:  [1, T, N] float32 tensor; == 1 means visible (see
                   `sam_pt_torch.utils.util.PointVisibilityType`).

`forward` is the same with numpy results; `evaluate_batch` and
`unpack_results` pack and flatten them as the reference tracker contract
does (`sam_pt/point_tracker/tracker.py:47-118`).
"""
from __future__ import annotations

import abc
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...ops.resize import resize_bilinear


class PointTracker(abc.ABC):
    @abc.abstractmethod
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    @property
    def device(self) -> torch.device:
        """The device the tracker's weights are on."""
        return next(self.model.parameters()).device

    def forward(self, rgbs: torch.Tensor, query_points: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        traj, vis = self.forward_device(rgbs, query_points)
        return traj.cpu().numpy(), vis.cpu().numpy()

    def __call__(self, rgbs, query_points):
        return self.forward(rgbs, query_points)

    def evaluate_batch(self, rgbs, query_points,
                       trajectories_gt: Optional[np.ndarray] = None,
                       visibilities_gt: Optional[np.ndarray] = None) -> dict:
        """`forward` on the tracker's device (rgbs [B, T, H, W, 3], numpy
        or a tensor, moved there; query_points [B, N, 3]), its outputs
        packed as numpy arrays beside the query points and the optional
        ground truth."""
        rgbs = torch.as_tensor(rgbs, device=self.device)
        query_points = np.asarray(query_points)
        trajectories, visibilities = self.forward(rgbs, query_points)
        b, t = rgbs.shape[:2]
        n = query_points.shape[1]
        if trajectories.shape != (b, t, n, 2):
            raise ValueError(f"trajectories of shape {trajectories.shape} "
                             f"for {b} videos of {t} frames and {n} points")
        return {
            "trajectories_pred": trajectories,
            "visibilities_pred": visibilities,
            "query_points": query_points,
            "trajectories_gt": (None if trajectories_gt is None
                                else np.asarray(trajectories_gt)),
            "visibilities_gt": (None if visibilities_gt is None
                                else np.asarray(visibilities_gt)),
        }

    @classmethod
    def unpack_results(cls, packed: dict, batch_idx: int) -> list:
        """`evaluate_batch`'s arrays as one record a (video, point)."""
        out = []
        traj = packed["trajectories_pred"]
        for b in range(traj.shape[0]):
            for n in range(traj.shape[2]):
                row = {
                    "idx": f"{batch_idx}_{b}_{n}",
                    "iter": batch_idx,
                    "video_idx": b,
                    "point_idx_in_video": n,
                    "query_point": packed["query_points"][b, n, :],
                    "trajectory_pred": traj[b, :, n, :],
                    "visibility_pred": packed["visibilities_pred"][b, :, n],
                }
                if packed.get("trajectories_gt") is not None:
                    row["trajectory_gt"] = packed["trajectories_gt"][b, :, n, :]
                    row["visibility_gt"] = packed["visibilities_gt"][b, :, n]
                out.append(row)
        return out

    def per_video(self, rgbs: torch.Tensor, compute: Callable[[], object]):
        """`compute()` once per video tensor, kept for the next call with
        the same tensor (the orchestrator calls once per batch of masks):
        the key is the tensor's storage, shape, strides and dtype, and the
        cache holds the tensor, so no other video can take its memory
        while cached."""
        key = (rgbs.data_ptr(), tuple(rgbs.shape), rgbs.stride(), rgbs.dtype)
        cache = getattr(self, "_video_cache", None)
        if cache is None or cache[1] != key:
            self._video_cache = None  # free the last video's entry first
            self._video_cache = (rgbs, key, compute())
        return self._video_cache[2]


def encode_in_chunks(encode: Callable[[torch.Tensor], torch.Tensor],
                     video: torch.Tensor, chunk: int,
                     target_hw: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """`encode` over a [T, H, W, 3] video in chunks of `chunk` frames (the
    last padded with its final frame, so every call has one shape), each
    chunk cast to float32 and resized to `target_hw` where that differs
    (by the dense weight matrices: a point tracker carries a last-bit
    difference of its input into its trajectories).
    Returns the encodings of the T frames, concatenated."""
    out = []
    for i in range(0, video.shape[0], chunk):
        frames = video[i:i + chunk]
        pad = chunk - frames.shape[0]
        if pad:
            frames = torch.cat([frames, frames[-1:].expand(pad, -1, -1, -1)])
        x = frames.float()
        if target_hw is not None and tuple(target_hw) != tuple(x.shape[1:3]):
            x = resize_bilinear(x, target_hw, dense=True)
        out.append(encode(x)[:chunk - pad])
    return torch.cat(out)
