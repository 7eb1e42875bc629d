"""PIPS++ point tracker: long windows with feature carry-over (counterpart
of `sam_pt_tpu/models/tracker/pips2/tracker.py`).

The video is resized to `image_size` on the device and encoded once.
Points are grouped by query frame; each group runs chained windows of up to
`max_sequence_length` frames, overlapping by one frame, forward from its
query frame and over the reversed frames before it, each window starting
from the last window's features and a zero-velocity continuation of its
track. Frame `ts` belongs to the forward pass; a query on the last frame is
pinned there. Visibility is always 1. Query coordinates are scaled per
axis (x by the width ratio, y by the height ratio), as in the JAX package.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional, Union

import numpy as np
import torch

from ....utils.checkpoint import load_or_randomize_
from ..api import PointTracker, encode_in_chunks
from .model import PipsPlusPlus


class PipsPlusPlusPointTracker(PointTracker):
    def __init__(self, checkpoint_path: Optional[str] = None,
                 stride: int = 8, max_sequence_length: int = 128,
                 iters: int = 16, image_size=(512, 896),
                 encode_chunk: int = 8, dtype: torch.dtype = torch.float32,
                 allow_random_init: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.stride = stride
        self.max_sequence_length = max_sequence_length
        self.iters = iters
        self.image_size = tuple(image_size) if image_size else None
        self.encode_chunk = encode_chunk
        self.model = PipsPlusPlus(stride=stride)
        load_or_randomize_(self.model, checkpoint_path,
                           allow_random_init=allow_random_init, seed=seed,
                           device=device)
        self.model.to(dtype).eval().requires_grad_(False)

    def _chain(self, fmaps: torch.Tensor, query_xy: torch.Tensor
               ) -> torch.Tensor:
        """Chained windows from frame 0, where every point starts.
        fmaps [T, h, w, C]; query_xy [N, 2] pixels -> [T, N, 2]."""
        t = fmaps.shape[0]
        msl = min(self.max_sequence_length, t)
        trajs = query_xy[None].expand(t, -1, -1).clone()
        cur, feats = 0, None
        while True:
            end = cur + msl
            if end > t:  # the last window ends at the video's end
                cur, end = max(cur - (end - t), 0), t
            if feats is not None:
                feats = tuple(f[:end - cur] for f in feats)
            coords, feats = self.model(fmaps[cur:end], trajs[cur:end], feats,
                                       iters=self.iters)
            trajs[cur:end] = coords
            trajs[end:] = coords[-1:]  # zero-velocity continuation
            if end >= t:
                return trajs
            cur += msl - 1

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("PIPS++ runs on one video at a time")
        video = rgbs[0]
        qp = np.asarray(query_points, np.float32)[0].copy()
        t, h, w, _ = video.shape
        ih, iw = self.image_size or (h, w)
        qp[:, 1] *= iw / w
        qp[:, 2] *= ih / h
        device = video.device
        fmaps = encode_in_chunks(self.model.encode_frames, video,
                                 self.encode_chunk, (ih, iw))

        groups = defaultdict(list)
        for i, ts in enumerate(qp[:, 0].astype(np.int64)):
            groups[int(ts)].append(i)
        traj = torch.zeros((t, len(qp), 2), device=device)
        for ts, idxs in groups.items():
            pts = torch.as_tensor(qp[idxs, 1:], device=device)
            sel = torch.as_tensor(idxs, device=device)
            if ts > 0:  # frames before ts, from the reversed prefix
                back = self._chain(fmaps[:ts + 1].flip(0), pts).flip(0)
                traj[:ts, sel] = back[:ts]
            if ts < t - 1:
                traj[ts:, sel] = self._chain(fmaps[ts:], pts)
            else:  # a query on the last frame has nothing after it
                traj[ts, sel] = pts
        traj = traj * torch.tensor([w / iw, h / ih], device=device)
        return traj[None], torch.ones((1, t, len(qp)), device=device)
