"""PIPS point tracker: chained 8-frame windows in both directions
(counterpart of `sam_pt_tpu/models/tracker/pips/tracker.py`).

From each point's query frame the window model runs over the next S
frames; the point's frontier then moves to the latest window frame whose
visibility clears a threshold that falls by 0.02 each time no frame of the
window clears it; the next window of that point starts at its frontier.
The same runs on the time-reversed video, and the two are stitched at
each point's query frame (backward before it, forward from it on).

The video is encoded once (in chunks of `encode_chunk` frames) and the
features are kept for the next call with the same video tensor, as the
orchestrator calls once per batch of masks. The frontier walk is host
logic on [N] arrays: each window that runs sends its [S, N] coordinates
and visibilities to the host in one copy, and a window runs only on the
points whose frontier is at its first frame.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ....ops.sampling import bilinear_sample
from ....utils.checkpoint import load_or_randomize_
from ..api import PointTracker, encode_in_chunks
from .model import Pips


class PipsPointTracker(PointTracker):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 stride: int = 4, s: int = 8,
                 initial_next_frame_visibility_threshold: float = 0.9,
                 iters: int = 6, encode_chunk: int = 8,
                 dtype: torch.dtype = torch.float32,
                 allow_random_init: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.stride = stride
        self.s = s
        self.iters = iters
        self.vis_threshold0 = initial_next_frame_visibility_threshold
        self.encode_chunk = encode_chunk
        self.model = Pips(s=s, stride=stride)
        load_or_randomize_(self.model, checkpoint_path,
                           allow_random_init=allow_random_init, seed=seed,
                           device=device)
        self.model.to(dtype).eval().requires_grad_(False)

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """video [T, H, W, 3] on the tracker's device -> features
        [T, H/stride, W/stride, C], encoded in chunks of `encode_chunk`
        frames (the last chunk padded with its final frame)."""
        return encode_in_chunks(self.model.encode_frames, video,
                                self.encode_chunk)

    def _features(self, rgbs: torch.Tensor) -> torch.Tensor:
        """The video's features, encoded once per video tensor."""
        return self.per_video(rgbs, lambda: self.encode_video(rgbs[0]))

    def _link(self, fmaps: torch.Tensor, query_points: np.ndarray,
              reverse: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Chained windows in one direction over fmaps [T, h, w, C] (frame
        i read as T-1-i when `reverse`); query_points [N, 3] (t, x, y) in
        that direction's time. Returns host trajectories [T, N, 2] and
        visibilities [T, N] (probabilities; 1 at the query frame, 0 where
        no window wrote)."""
        s, t = self.s, fmaps.shape[0]
        n = query_points.shape[0]
        device = fmaps.device
        cols = np.arange(n)
        start = query_points[:, 0].astype(np.int64)
        traj = np.zeros((t, n, 2), np.float32)
        vis = np.zeros((t, n), np.float32)
        traj[start, cols] = query_points[:, 1:]
        vis[start, cols] = 1.0

        def frames(idx):
            idx = np.asarray(idx)
            return torch.as_tensor(t - 1 - idx if reverse else idx,
                                   device=device)

        # The query-frame feature at each query point, grouped by frame.
        grid = torch.as_tensor(query_points[:, 1:] / self.stride,
                               device=device)
        feat_init = torch.empty((n, fmaps.shape[-1]), device=device)
        for f in np.unique(start):
            sel = torch.as_tensor(np.nonzero(start == f)[0], device=device)
            feat_init[sel] = bilinear_sample(
                fmaps[frames([f])], grid[sel, 0][None],
                grid[sel, 1][None])[0].float()

        frontier = start.copy()
        for cf in range(t - 1):
            active = np.nonzero(frontier == cf)[0]
            if not len(active):
                continue
            last = min(cf + s, t) - 1  # frames past the video are dropped
            sel = torch.as_tensor(active, device=device)
            coords, vlog, _ = self.model(
                fmaps[frames(np.minimum(cf + np.arange(s), t - 1))],
                torch.as_tensor(traj[cf, active], device=device),
                feat_init[sel], iters=self.iters)
            out = torch.cat([coords, torch.sigmoid(vlog)[..., None]],
                            dim=-1).cpu().numpy()  # one copy per window
            traj[cf + 1:last + 1, active] = out[1:last + 1 - cf, :, :2]
            vis[cf + 1:last + 1, active] = out[1:last + 1 - cf, :, 2]
            # Walk each frontier back from the window's last frame to the
            # latest frame above the threshold; below it everywhere, the
            # threshold falls by 0.02 and the walk restarts at the end.
            nxt = np.full(len(active), last)
            th = np.full(len(active), self.vis_threshold0, np.float32)
            below = vis[nxt, active] <= th
            while below.any():
                nxt = np.where(below, nxt - 1, nxt)
                wrapped = nxt <= cf
                th = np.where(wrapped, th - np.float32(0.02), th)
                nxt = np.where(wrapped, last, nxt)
                below = vis[nxt, active] <= th
            frontier[active] = nxt
        return traj, vis

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("PIPS links one video at a time")
        qp = np.asarray(query_points, np.float32)[0]
        fmaps = self._features(rgbs)
        t = fmaps.shape[0]
        traj_f, vis_f = self._link(fmaps, qp, reverse=False)
        qp_b = qp.copy()
        qp_b[:, 0] = t - qp[:, 0] - 1
        traj_b, vis_b = self._link(fmaps, qp_b, reverse=True)
        before = np.arange(t)[:, None] < qp[:, 0].astype(np.int64)[None]
        traj = np.where(before[..., None], traj_b[::-1], traj_f)
        vis = (np.where(before, vis_b[::-1], vis_f) > 0.5).astype(np.float32)
        return (torch.from_numpy(traj[None]).to(rgbs.device),
                torch.from_numpy(vis[None]).to(rgbs.device))
