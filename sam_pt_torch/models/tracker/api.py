"""Point tracker contract (counterpart of `sam_pt_tpu/models/tracker/api.py`).

  forward_device(rgbs, query_points) -> (trajectories, visibilities)

    rgbs:          [1, T, H, W, 3] uint8 video on the tracker's device
                   (channels-last, as in the JAX package).
    query_points:  [1, N, 3] float32 numpy (t, x, y).
    trajectories:  [1, T, N, 2] float32 tensor (x, y) per frame.
    visibilities:  [1, T, N] float32 tensor; == 1 means visible (see
                   `sam_pt_torch.utils.util.PointVisibilityType`).

`forward` is the same with numpy results.
"""
from __future__ import annotations

import abc
from typing import Tuple

import numpy as np
import torch


class PointTracker(abc.ABC):
    @abc.abstractmethod
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    def forward(self, rgbs: torch.Tensor, query_points: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        traj, vis = self.forward_device(rgbs, query_points)
        return traj.cpu().numpy(), vis.cpu().numpy()

    def __call__(self, rgbs, query_points):
        return self.forward(rgbs, query_points)
