"""RAFT point tracker: trajectories integrated through chained optical flow
(counterpart of `sam_pt_tpu/models/tracker/raft/tracker.py`).

RAFT computes the flow between each pair of neighbouring frames in both
directions (frames edge-padded to multiples of 8, pairs in chunks of
`flow_chunk`). Each point then moves forward from its query frame by the
forward flow sampled at its position, and the frames before its query
frame are filled backwards from their successor by the backward flow.
A point is visible where it lies inside the frame.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.sampling import bilinear_sample_nchw
from ....utils.checkpoint import load_or_randomize_
from ...batch_norm import reset_batch_norm_stats_
from ..api import PointTracker
from .model import Raft


class RaftPointTracker(PointTracker):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 iters: int = 32, flow_chunk: int = 4,
                 dtype: torch.dtype = torch.float32,
                 allow_random_init: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.iters = iters
        self.flow_chunk = flow_chunk
        self.model = Raft()
        if not load_or_randomize_(self.model, checkpoint_path,
                                  allow_random_init=allow_random_init,
                                  seed=seed, device=device):
            reset_batch_norm_stats_(self.model)
        self.model.to(dtype).eval().requires_grad_(False)

    def compute_flows(self, frames: torch.Tensor):
        """frames [T, 3, H, W] in [-1, 1] -> (forward, backward) flows
        [T-1, 2, H, W] between frames i and i + 1."""
        fwd, bwd = [], []
        bs = self.flow_chunk
        for i in range(0, frames.shape[0] - 1, bs):
            a, b = frames[:-1][i:i + bs], frames[1:][i:i + bs]
            pad = bs - a.shape[0]
            if pad:
                a = torch.cat([a, a[-1:].expand(pad, -1, -1, -1)])
                b = torch.cat([b, b[-1:].expand(pad, -1, -1, -1)])
            fwd.append(self.model(a, b, iters=self.iters)[:bs - pad])
            bwd.append(self.model(b, a, iters=self.iters)[:bs - pad])
        return torch.cat(fwd), torch.cat(bwd)

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("RAFT chains one video at a time")
        video = rgbs[0]
        qp = torch.as_tensor(np.asarray(query_points, np.float32)[0],
                             device=video.device)
        t, h, w, _ = video.shape
        q_t, q_xy = qp[:, 0], qp[:, 1:]
        if t == 1:
            coords = q_xy[None]
        else:
            frames = F.pad(video.permute(0, 3, 1, 2).float(),
                           (0, -w % 8, 0, -h % 8), mode="replicate")
            flows_fwd, flows_bwd = self.compute_flows(frames / 127.5 - 1.0)
            coords = integrate(flows_fwd[..., :h, :w], flows_bwd[..., :h, :w],
                               q_t, q_xy)
        x, y = coords[..., 0], coords[..., 1]
        vis = ((x >= 0) & (y >= 0) & (x < w) & (y < h)).float()
        return coords[None], vis[None]


def integrate(flows_fwd: torch.Tensor, flows_bwd: torch.Tensor,
              q_t: torch.Tensor, q_xy: torch.Tensor) -> torch.Tensor:
    """flows [T-1, 2, H, W]; q_t [N]; q_xy [N, 2] -> coords [T, N, 2].

    Forward: from frame 0 (the query where q_t == 0, else 0), each frame
    adds the flow sampled at the last position, and a point is reset to
    its query on its query frame. Backward: frames before a point's query
    frame take their successor plus the backward flow sampled there."""
    def step(flow, pts):
        return pts + bilinear_sample_nchw(flow[None], pts[None, :, 0],
                                          pts[None, :, 1])[0].T

    coord = torch.where((q_t == 0)[:, None], q_xy, torch.zeros_like(q_xy))
    coords = [coord]
    for ti in range(1, flows_fwd.shape[0] + 1):
        coord = torch.where((q_t == ti)[:, None], q_xy,
                            step(flows_fwd[ti - 1], coord))
        coords.append(coord)
    succ = coords[-1]
    for ti in range(flows_bwd.shape[0] - 1, -1, -1):
        succ = torch.where((ti < q_t)[:, None], step(flows_bwd[ti], succ),
                           coords[ti])
        coords[ti] = succ
    return torch.stack(coords)
