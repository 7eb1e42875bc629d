"""The reference's entry points for a SAM-PT configuration: the checkpoint
names and shapes it runs on, the plain computation of each layer that
the benchmark compares (query points, embeddings, tracks, decode chain,
fusion), and the yardstick's counts for the configuration (the kernel
launches a video should make, its model FLOPs).

These are the functions that `harness/check.py` and `harness/main.py`
call on a configuration's `reference` module (`registry.py` lists them).
Nothing here imports the program under test: the benchmark hands both
sides the same frames, masks and state dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import flops
from . import sam, trackers
from .ops import F32, Precision

VISIBLE = 1.0  # PointVisibilityType.VISIBLE
OUTSIDE_FRAME = -2.0  # PointVisibilityType.OUTSIDE_FRAME
BORDER = 0.01  # points this close to the border count as outside the frame


def param_shapes(config: dict) -> dict:
    """{"sam": {name: shape}, "tracker": {name: shape}}."""
    tracker = config["tracker"]
    return {"sam": sam.param_shapes(config["sam"]),
            "tracker": trackers.TRACKERS[tracker["name"]][0](tracker)}


def query_point_faults(query_points: np.ndarray, masks: np.ndarray,
                       timesteps: np.ndarray, n_pos: int) -> int:
    """How many of the query points [M, P, 3] break what the sampler
    promises: the query frame as their time, positives on a pixel of their
    mask, negatives off it (masks [M, H, W] in {0, 1})."""
    m, p, _ = query_points.shape
    h, w = masks.shape[1:]
    faults = int((query_points[..., 0] != timesteps[:, None]).sum())
    xy = np.rint(query_points[..., 1:]).astype(np.int64)
    off = ((xy[..., 0] < 0) | (xy[..., 0] >= w) | (xy[..., 1] < 0)
           | (xy[..., 1] >= h) | (np.abs(query_points[..., 1:] - xy) > 0).any(-1))
    faults += int(off.sum())
    xs, ys = xy[..., 0].clip(0, w - 1), xy[..., 1].clip(0, h - 1)
    inside = masks[np.arange(m)[:, None], ys, xs] > 0.5
    expected = np.arange(p)[None, :] < n_pos
    return faults + int(((inside != expected) & ~off).sum())


def embeddings(frames: torch.Tensor, sd: dict, config: dict,
               p: Precision = F32) -> torch.Tensor:
    return sam.encode(frames, sd, config["sam"], p)


def video_embeddings(video: torch.Tensor, frames: list, sd: dict,
                     config: dict, p: Precision = F32) -> torch.Tensor:
    """Embeddings of every frame of `video` [T, H, W, 3] as the program
    hands them out: the reference's on `frames`, zero on the others (the
    control's; the comparison reads only the drawn frames)."""
    s = config["sam"]
    grid = s["image_size"] // s["patch_size"]
    emb = torch.zeros((video.shape[0], grid, grid, s["out_chans"]),
                      device=video.device)
    emb[frames] = embeddings(video[frames], sd, config, p)
    return emb


def threshold(config: dict) -> float:
    """The probability above which the configuration's tracker calls a
    point visible."""
    tracker = config["tracker"]
    return trackers.TRACKERS[tracker["name"]][2](tracker)


def visibility(traj: torch.Tensor, prob: torch.Tensor, hw, config: dict):
    """SAM-PT's visibilities [T, M, P]: -2 where the point lies within 1% of
    the frame's border, else 1 above the tracker's threshold, else 0."""
    h, w = hw
    x, y = traj[..., 0] / w, traj[..., 1] / h
    oob = (x < BORDER) | (x > 1 - BORDER) | (y < BORDER) | (y > 1 - BORDER)
    vis = (prob > threshold(config)).float()
    return torch.where(oob, torch.full_like(vis, OUTSIDE_FRAME), vis)


def tracks(video: torch.Tensor, query_points: np.ndarray, sd: dict,
           config: dict, p: Precision = F32):
    """-> (trajectories [T, M, P, 2], visibilities [T, M, P] with SAM-PT's
    values, the visibility probabilities [T, M, P]), in mask batches as
    SamPt tracks them."""
    tracker = config["tracker"]
    track = trackers.TRACKERS[tracker["name"]][1]
    m, n, _ = query_points.shape
    t, h, w, _ = video.shape
    bs = config["sam_pt"]["point_tracker_mask_batch_size"]
    trajs, probs = [], []
    for i in range(0, m, bs):
        batch = query_points[i:i + bs].reshape(-1, 3)
        traj, prob = track(video, batch, sd, tracker, p)
        nb = batch.shape[0] // n
        trajs.append(traj.reshape(t, nb, n, 2))
        probs.append(torch.as_tensor(prob).reshape(t, nb, n).float())
    traj, prob = torch.cat(trajs, 1), torch.cat(probs, 1)
    return traj, visibility(traj, prob, (h, w), config), prob


def prompt(traj: torch.Tensor, vis: torch.Tensor, obj: int, n_pos: int,
           other_positives: bool):
    """One frame's prompt for object `obj`: points [N, 2] and labels [N]
    (1 positive, 0 negative, -1 absent) from its own visible points and,
    where configured, the other objects' visible positives as negatives.
    traj [M, P, 2], vis [M, P]."""
    m, p = vis.shape
    visible = vis == VISIBLE
    own = torch.where(torch.arange(p, device=vis.device) < n_pos, 1, 0)
    labels = [torch.where(visible[obj], own, -1)]
    points = [traj[obj]]
    if other_positives:
        for o in range(m):
            if o != obj:
                labels.append(torch.where(visible[o, :n_pos], 0, -1))
                points.append(traj[o, :n_pos])
    return torch.cat(points), torch.cat(labels)


def decode(emb, points, labels, hw, sd, config: dict, p: Precision = F32):
    """-> (logits [H, W], IoU, whether any prompt point was visible)."""
    settings = config["sam_pt"]
    logits, iou = sam.decode_chain(
        emb, points, labels, hw, sd, config["sam"]["image_size"],
        settings["iterative_refinement_iterations"],
        settings["negative_points_per_mask"] > 0, p)
    return logits, iou, bool((labels != -1).any())


def fuse(logits: torch.Tensor, gt: torch.Tensor, gt_ts) -> torch.Tensor:
    """The VOS harness's fusion: logits [M, T, H, W], each mask held off
    before its query frame and set to its ground truth there, then the
    argmax against a zero background (the first of equal values) ->
    [T, H, W] uint8 (0 background, i + 1 for mask i), a frame at a time."""
    m, t = logits.shape[:2]
    out = []
    for f in range(t):
        x = logits[:, f].float()
        for i, ts in enumerate(gt_ts):
            if f < ts:
                x[i] = -torch.inf
            elif f == ts:
                x[i] = torch.where(gt[i] > 0.5, torch.inf, -torch.inf)
        stacked = torch.cat([torch.zeros_like(x[:1]), x])
        out.append(first_argmax(stacked))
    return torch.stack(out).to(torch.uint8)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """The index of the first maximum along axis 0."""
    best = x.max(0, keepdim=True).values
    idx = torch.arange(x.shape[0], device=x.device).reshape(
        -1, *[1] * (x.ndim - 1))
    return torch.where(x == best, idx, x.shape[0]).min(0).values


def launch_schedule(config: dict, frames: int, objects: int) -> dict:
    """The kernel launches of one video of `frames` x `objects`."""
    return flops.launch_schedule(config["sam"], config["sam_pt"], frames,
                                 objects)


def video_flops(config: dict, frames: int, objects: int, hw) -> dict:
    """Model FLOPs of one video by part."""
    return flops.video_flops(config, frames, objects, hw)
