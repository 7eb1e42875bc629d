"""CoTracker point tracker: sliding windows, support grid, backward merge
(counterpart of `sam_pt_tpu/models/tracker/cotracker/tracker.py`).

The video is resized to `interp_shape` and encoded once; the windowed model
runs forward in time, then on the time-flipped features, and the backward
result fills every entry the forward pass left exactly zero (the frames
before each point's first window). Visibility = sigmoid > threshold.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ....ops.sampling import bilinear_sample
from ....utils.checkpoint import load_or_randomize_
from ..api import PointTracker, encode_in_chunks
from .model import CoTracker


def get_points_on_a_grid(grid_size: int, extent_hw) -> np.ndarray:
    """[1, grid_size^2, 2] (x, y) support points with a w // 64 margin
    (CoTracker v1); grid_size == 1 is the image centre."""
    h, w = extent_hw
    if grid_size == 1:
        return np.array([[[w / 2.0, h / 2.0]]], np.float32)
    step = w // 64
    ys = np.linspace(step, h - step, grid_size)
    xs = np.linspace(step, w - step, grid_size)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gx, gy], axis=-1).reshape(1, -1, 2).astype(np.float32)


class CoTrackerPointTracker(PointTracker):
    """The keys of `configs/model/point_tracker/cotracker.yaml`, in the JAX
    constructor's order, plus `seed` and `device` for random weights, as
    the PIPS tracker takes them. The public `cotracker_stride_4_wind_8.pth`
    loads as it is; a missing file raises unless `allow_random_init`. A
    module that is already built comes in by `model=` (then
    `checkpoint_path`, `s`, `stride`, `dtype` and the rest of the weights'
    keys are not read). `add_debug_visualisations` is accepted and unused,
    as in the JAX package."""

    def __init__(self, checkpoint_path: Optional[str] = None,
                 interp_shape=(384, 512),
                 visibility_threshold: float = 0.7,
                 support_grid_size: int = 2,
                 support_grid_every_n_frames: int = 12,
                 add_debug_visualisations: bool = False,
                 s: int = 8, stride: int = 4, iters: int = 6,
                 encode_chunk: int = 8,
                 dtype: torch.dtype = torch.float32,
                 allow_random_init: bool = False, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 model: Optional[CoTracker] = None):
        if model is None:
            model = CoTracker(s=s, stride=stride)
            load_or_randomize_(model, checkpoint_path,
                               allow_random_init=allow_random_init,
                               seed=seed, device=device)
            model.to(dtype).eval().requires_grad_(False)
        self.model = model
        self.interp_shape = tuple(interp_shape) if interp_shape else None
        self.visibility_threshold = visibility_threshold
        self.support_grid_size = support_grid_size
        self.support_grid_every_n_frames = support_grid_every_n_frames
        self.iters = iters
        self.encode_chunk = encode_chunk
        self.s = model.s
        self.stride = model.stride
        self._fmap_cache = None

    def _track(self, fmaps: torch.Tensor, queries: torch.Tensor, t: int):
        """CoTracker v1 windowed forward over all tracks.

        Windows start at 0, S/2, ... while start < t - S/2; reads past the
        video repeat its last frame. Per window only tracks whose query
        frame is before the window's end take part (the others are masked
        out of the space attention and their writes dropped); tracks
        carried from the previous window start from its predictions.
        Frames before a track's first window stay exactly 0. The track and
        visibility buffers are updated in place by slice assignment.
        Returns traj [t, N, 2] (interp pixels), vis [t, N] probabilities.
        """
        s = self.s
        device = fmaps.device
        n = queries.shape[0]
        q_t = queries[:, 0].long()
        q_xy = queries[:, 1:] / self.stride
        feats = bilinear_sample(fmaps[q_t], q_xy[:, None, 0],
                                q_xy[:, None, 1])[:, 0]  # [N, C]
        frame_idx = torch.arange(t, device=device)
        track_mask = (frame_idx[:, None] >= q_t[None, :]).float()

        traj = torch.zeros((t + s, n, 2), device=device)
        vis = torch.zeros((t + s, n), device=device)
        prev = -(t + s)  # no previous window: every track is fresh
        win = torch.arange(s, device=device)
        for ind in range(0, t - s // 2, s // 2):
            raw = ind + win
            frames = raw.clamp(max=t - 1)
            real = (raw < t).float()
            active = q_t < ind + s
            fresh = (q_t >= prev + s)[None, :]
            tm = torch.where(fresh, track_mask[frames],
                             (raw >= ind + s // 2).float()[:, None])
            tm = tm * real[:, None]
            init_idx = frames.clamp(max=prev + s - 1).clamp(0, t - 1)
            coords_init = torch.where(fresh[..., None], q_xy[None],
                                      traj[init_idx])
            vis_init = torch.where(fresh, torch.full_like(vis[init_idx], 10.0),
                                   vis[init_idx])
            coords_w, vis_w, _ = self.model(
                fmaps[frames], coords_init, feats, tm, iters=self.iters,
                vis_init=vis_init, active=active)
            write = (real[:, None] * active[None, :].float()) > 0
            traj[ind:ind + s] = torch.where(write[..., None], coords_w,
                                            traj[ind:ind + s])
            vis[ind:ind + s] = torch.where(write, vis_w, vis[ind:ind + s])
            prev = ind
        return traj[:t] * self.stride, torch.sigmoid(vis[:t])

    @torch.no_grad()
    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if rgbs.shape[0] != 1:
            raise ValueError("CoTracker runs on one video at a time")
        video = rgbs[0]
        qp = np.asarray(query_points, np.float32)[0]
        t, h, w, _ = video.shape
        n_points = qp.shape[0]
        device = video.device

        ih, iw = self.interp_shape or (h, w)
        if (ih, iw) != (h, w):
            qp = qp.copy()
            qp[:, 1] *= iw / w
            qp[:, 2] *= ih / h

        t_orig = t
        if t < self.s:  # short videos repeat their last frame
            video = torch.cat(
                [video, video[-1:].expand(self.s - t, -1, -1, -1)])
            t = self.s

        queries = qp
        if self.support_grid_size > 0:
            extra = []
            for i in range(0, t_orig, self.support_grid_every_n_frames):
                grid = get_points_on_a_grid(self.support_grid_size,
                                            (ih, iw))[0]
                extra.append(np.concatenate(
                    [np.full((len(grid), 1), float(i)), grid], axis=1))
            queries = np.concatenate([qp] + extra, 0).astype(np.float32)

        # Encode once per video: the orchestrator calls once per batch of
        # masks with the same video tensor object (kept alive by the cache).
        cache = self._fmap_cache
        if cache is not None and cache[0] is rgbs and cache[1] == (ih, iw):
            fmaps = cache[2]
        else:
            fmaps = encode_in_chunks(self.model.encode_frames, video,
                                     self.encode_chunk, (ih, iw))
            self._fmap_cache = (rgbs, (ih, iw), fmaps)

        q_f = torch.as_tensor(queries, device=device)
        traj_f, vis_f = self._track(fmaps, q_f, t)

        queries_b = queries.copy()
        queries_b[:, 0] = t_orig - queries_b[:, 0] - 1
        fmaps_b = torch.flip(fmaps[:t_orig], dims=[0])
        if t_orig < t:  # the flipped video is re-padded with frame 0
            fmaps_b = torch.cat(
                [fmaps_b, fmaps[:1].expand(t - t_orig, -1, -1, -1)])
        traj_b, vis_b = self._track(
            fmaps_b, torch.as_tensor(queries_b, device=device), t)
        traj_b = torch.flip(traj_b[:t_orig], dims=[0])
        vis_b = torch.flip(vis_b[:t_orig], dims=[0])

        traj_f, vis_f = traj_f[:t_orig], vis_f[:t_orig]
        zero = traj_f == 0
        traj = torch.where(zero, traj_b, traj_f)
        vis = torch.where(zero[..., 0], vis_b, vis_f)
        traj = traj[:, :n_points]
        vis = (vis[:, :n_points] > self.visibility_threshold).float()
        traj = traj * torch.tensor([w / float(iw), h / float(ih)],
                                   device=device)
        return traj[None], vis[None]
