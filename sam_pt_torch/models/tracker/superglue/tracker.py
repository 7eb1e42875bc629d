"""SuperGlue point "tracker" (counterpart of
`sam_pt_tpu/models/tracker/superglue/tracker.py`): each frame's keypoints
matched against frame 0's.

It keeps per-video state: `set_masks` must come before `forward_device`,
which consumes the masks (SamPt calls it with every mask in one batch).
SuperPoint runs on the frames in batches of DETECT_CHUNK (frame 0's
keypoints and descriptors once), SuperGlue on the T-1 pairs (frame 0,
frame i) in batches of MATCH_CHUNK, both on the device. The matches come
to the host, where each frame's matched target keypoints are split per
mask into positives (inside the mask, tested on the target-frame keypoint)
and negatives, and drawn to each mask's quotas with replacement by
`np.random.default_rng(seed)`, in the JAX package's order (frame, then
mask, then positives before negatives), so that with the same seed the
trajectories equal its. A shortfall is padded with (-1, -1), invisible;
frame 0 carries the query points.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ....ops.color import rgb_to_gray
from ....utils.checkpoint import load_superglue_checkpoint, randomize_
from ...batch_norm import reset_batch_norm_stats_
from ..api import PointTracker
from .superglue import SuperGlue
from .superpoint import SuperPoint


# Frames a SuperPoint call (its first conv's output is 105 MB a 480 x 854
# frame in float32) and pairs a SuperGlue call (its attention logits are
# 34 MB a pair at 1024 keypoints).
DETECT_CHUNK = 8
MATCH_CHUNK = 32


def match_data(det0, det1, hw):
    """SuperGlue's input from two SuperPoint outputs of B frames each."""
    data = {f"{k}{i}": det[k] for i, det in enumerate((det0, det1))
            for k in ("keypoints", "scores", "valid", "descriptors")}
    data["image_shape"] = tuple(hw)
    return data


class SuperGluePointTracker(PointTracker):
    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        superpoint_checkpoint_path: Optional[str] = None,
        positive_points_per_mask: int = 8,
        negative_points_per_mask: int = 1,
        max_keypoints: int = 1024,
        sinkhorn_iterations: int = 100,
        match_threshold: float = 0.2,
        nms_radius: int = 4,
        keypoint_threshold: float = 0.005,
        allow_random_init: bool = False,
        seed: int = 72,
        device: Union[str, torch.device] = "cuda",
    ):
        self.positive_points_per_mask = positive_points_per_mask
        self.negative_points_per_mask = negative_points_per_mask
        self.superpoint = SuperPoint(max_keypoints=max_keypoints,
                                     nms_radius=nms_radius,
                                     keypoint_threshold=keypoint_threshold)
        self.superglue = SuperGlue(sinkhorn_iterations=sinkhorn_iterations,
                                   match_threshold=match_threshold)
        device = torch.device(device)
        self.superpoint.to(device)
        self.superglue.to(device)
        found = [p is not None and os.path.exists(str(p))
                 for p in (superpoint_checkpoint_path, checkpoint_path)]
        if all(found):
            load_superglue_checkpoint(superpoint_checkpoint_path,
                                      checkpoint_path, self.superpoint,
                                      self.superglue)
        elif allow_random_init:
            generator = torch.Generator(device=device).manual_seed(seed)
            randomize_(self.superpoint, generator)
            reset_batch_norm_stats_(randomize_(self.superglue, generator))
        else:
            raise FileNotFoundError(
                f"SuperGlue checkpoints not found: {checkpoint_path} / "
                f"{superpoint_checkpoint_path} (set allow_random_init=True "
                f"to run on random weights)")
        for model in (self.superpoint, self.superglue):
            model.eval().requires_grad_(False)
        self.masks: Optional[np.ndarray] = None
        self.rng = np.random.default_rng(seed)

    @property
    def device(self) -> torch.device:
        return next(self.superpoint.parameters()).device

    def set_masks(self, masks: np.ndarray) -> None:
        """masks [n_masks, H, W] of the next `forward_device`'s video."""
        self.masks = np.asarray(masks)

    @torch.no_grad()
    def detect(self, gray: torch.Tensor):
        """SuperPoint over [T, H, W] grey frames in [0, 1], in batches of
        DETECT_CHUNK -> its outputs for the T frames."""
        outs = [self.superpoint(gray[i:i + DETECT_CHUNK])
                for i in range(0, gray.shape[0], DETECT_CHUNK)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    @torch.no_grad()
    def match(self, det0, det1, hw):
        """SuperGlue of frame 0 (det0, one frame) against each of det1's
        B frames, in batches of MATCH_CHUNK -> matches0 [B, K]."""
        b = det1["keypoints"].shape[0]
        out = []
        for i in range(0, b, MATCH_CHUNK):
            part = {k: v[i:i + MATCH_CHUNK] for k, v in det1.items()}
            n = part["keypoints"].shape[0]
            first = {k: v.expand(n, *v.shape[1:]) for k, v in det0.items()}
            out.append(self.superglue(match_data(first, part, hw))[
                "matches0"])
        return torch.cat(out)

    def forward_device(self, rgbs: torch.Tensor, query_points: np.ndarray):
        if self.masks is None:
            raise ValueError("set_masks must be called before each forward "
                             "of SuperGluePointTracker")
        if rgbs.shape[0] != 1:
            raise ValueError("SuperGlue tracks one video at a time")
        masks, self.masks = self.masks > 0.5, None  # consumed
        qp = np.asarray(query_points, np.float32)[0]
        t, h, w, _ = rgbs.shape[1:]
        n_points = qp.shape[0]
        n_pos = self.positive_points_per_mask
        n_neg = self.negative_points_per_mask
        ppm = n_pos + n_neg
        n_masks = masks.shape[0]
        if ppm * n_masks != n_points:
            raise ValueError(f"{n_points} query points for {n_masks} masks "
                             f"of {ppm} points")

        trajectories = np.zeros((t, n_masks, ppm, 2), np.float32)
        visibilities = np.zeros((t, n_masks, ppm), np.float32)
        trajectories[0] = qp[:, 1:].reshape(n_masks, ppm, 2)
        if t > 1:
            det = self.detect(rgb_to_gray(rgbs[0]) / 255.0)
            det0 = {k: v[:1] for k, v in det.items()}
            det1 = {k: v[1:] for k, v in det.items()}
            matches = self.match(det0, det1, (h, w)).cpu().numpy()
            kpts1 = det1["keypoints"].cpu().numpy()
        for i in range(1, t):
            m = matches[i - 1]
            mk1 = kpts1[i - 1][np.clip(m[m > -1], 0, None)]
            iy1 = np.clip(mk1[:, 1].astype(int), 0, h - 1)
            ix1 = np.clip(mk1[:, 0].astype(int), 0, w - 1)
            for mi in range(n_masks):
                inside = masks[mi][iy1, ix1]
                for pts, quota, off in ((mk1[inside], n_pos, 0),
                                        (mk1[~inside], n_neg, n_pos)):
                    take = min(len(pts), quota)
                    out = np.full((quota, 2), -1.0, np.float32)
                    if len(pts) > 0:
                        out[:take] = pts[self.rng.choice(len(pts), size=take)]
                    trajectories[i, mi, off:off + quota] = out
                    visibilities[i, mi, off:off + take] = 1.0
        device = rgbs.device
        return (torch.from_numpy(trajectories.reshape(t, n_points, 2)).to(
                    device)[None],
                torch.from_numpy(visibilities.reshape(t, n_points)).to(
                    device)[None])
