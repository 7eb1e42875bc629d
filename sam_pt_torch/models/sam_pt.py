"""SAM-PT orchestrator, device flow without point re-initialisation
(counterpart of the plain path of `sam_pt_tpu/models/sam_pt.py`).

Per video: upload once; embed every frame with the batched SAM encoder;
sample query points from the query masks on the host; track them; build
fixed-shape padded prompts for every (frame, object) pair on the device;
decode all pairs in chunks through the decode chain (positives-only pass,
all-points pass with the mask as input, then box-refinement passes); gate
by IoU; return device tensors.

The box-refinement passes run unconditionally: the JAX package stops its
loop at the exact fixed point, which gives the same output, but on a GPU
that test costs a host sync per pass.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.resize import resize_planes
from ..utils.query_points import (
    extract_corner_points,
    extract_kmedoid_points,
    extract_mixed_points,
    extract_random_mask_points,
)
from ..utils.util import PointVisibilityType
from .sam.predictor import SamPredictor
from .tracker.api import PointTracker

NEG_INF = -float("inf")


def build_prompts(traj: torch.Tensor, vis: torch.Tensor, n_pos: int,
                  has_neg: bool, add_other: bool):
    """traj [T, M, P, 2], vis [T, M, P] -> points [T, M, N, 2], labels
    [T, M, N] (1 positive, 0 negative, -1 pad). With `add_other`, every
    other object's positives join as negatives (pad when invisible)."""
    t, m, p, _ = traj.shape
    device = traj.device
    visible = vis == 1
    base = torch.ones(p, dtype=torch.long, device=device)
    if has_neg:
        base[n_pos:] = 0
    labels = torch.where(visible, base, torch.full_like(base, -1))
    points = traj.float()
    if add_other and m > 1:
        oidx = torch.as_tensor(
            [[o for o in range(m) if o != mi] for mi in range(m)],
            device=device)  # [M, M-1]
        opts = points[:, :, :n_pos][:, oidx]  # [T, M, M-1, n_pos, 2]
        ovis = visible[:, :, :n_pos][:, oidx]
        points = torch.cat([points, opts.reshape(t, m, -1, 2)], dim=2)
        other = torch.where(ovis, 0, -1).reshape(t, m, -1)
        labels = torch.cat([labels, other], dim=2)
    return points, labels


class SamPt:
    def __init__(
        self,
        point_tracker: PointTracker,
        sam_predictor: SamPredictor,
        sam_iou_threshold: float = 0.7,
        positive_point_selection_method: str = "kmedoids",
        negative_point_selection_method: str = "mixed",
        positive_points_per_mask: int = 8,
        negative_points_per_mask: int = 1,
        add_other_objects_positive_points_as_negative_points: bool = False,
        point_tracker_mask_batch_size: int = 5,
        iterative_refinement_iterations: int = 0,
        sam_decode_chunk: int = 32,
        sam_encode_chunk: int = 4,
        seed: int = 72,
        logits_dtype: torch.dtype = torch.float16,
    ):
        self.point_tracker = point_tracker
        self.sam_predictor = sam_predictor
        self.sam_iou_threshold = sam_iou_threshold
        self.positive_point_selection_method = positive_point_selection_method
        self.negative_point_selection_method = negative_point_selection_method
        self.positive_points_per_mask = positive_points_per_mask
        self.negative_points_per_mask = negative_points_per_mask
        self.add_other_objects_positive_points_as_negative_points = (
            add_other_objects_positive_points_as_negative_points)
        self.point_tracker_mask_batch_size = point_tracker_mask_batch_size
        self.iterative_refinement_iterations = iterative_refinement_iterations
        self.sam_decode_chunk = sam_decode_chunk
        self.sam_encode_chunk = sam_encode_chunk
        self.logits_dtype = logits_dtype
        self.rng = np.random.default_rng(seed)

    @property
    def device(self) -> torch.device:
        return self.sam_predictor.model.device

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, video: Dict) -> Dict:
        """video: 'image' [T, H, W, 3] uint8 numpy, 'target_hw' (h, w),
        'query_masks' [M, H, W] and 'query_point_timestep' [M].

        Returns device tensors: logits [M, T, h, w] float16 (-inf planes
        where a pair was gated), scores [M], scores_per_frame [T, M],
        trajectories [T, M, P, 2] and visibilities [T, M, P].
        """
        images = np.asarray(video["image"])
        if images.dtype != np.uint8:
            raise ValueError("input images must be uint8 (0-255)")
        if video.get("query_masks") is None:
            raise NotImplementedError("the port takes query masks only")
        t, h, w, _ = images.shape
        images_dev = torch.from_numpy(images).to(self.device)
        emb = self._encode_all_frames(images_dev)

        query_masks = np.asarray(video["query_masks"], np.float32)
        timesteps = np.asarray(video["query_point_timestep"], np.float32)
        query_points = self.extract_query_points(images, query_masks,
                                                 timesteps)
        n_masks, n_points, _ = query_points.shape

        trajectories, visibilities = self._track_points_device(
            images_dev, query_points, (h, w))
        logits, scores_per_frame = self._apply_sam_device(
            (h, w), trajectories, visibilities, emb)
        scores = scores_per_frame.mean(dim=0)

        target_hw = tuple(video["target_hw"])
        if (h, w) != target_hw:
            # Whole-plane -inf sentinels would turn to NaN in the matrix
            # resize (0 * inf): clamp for the resize, then restore them.
            blank = torch.isneginf(logits).all(dim=-1).all(dim=-1)
            clamped = torch.clamp(logits, min=-30000.0)
            logits = resize_planes(clamped, target_hw)
            logits = torch.where(blank[..., None, None],
                                 torch.full_like(logits, NEG_INF), logits)
        resize = torch.tensor([target_hw[1] / w, target_hw[0] / h],
                              device=trajectories.device)
        trajectories = trajectories * resize
        assert trajectories.shape == (t, n_masks, n_points, 2)
        return {
            "logits": logits.to(torch.float16),
            "scores": scores,
            "scores_per_frame": scores_per_frame,
            "trajectories": trajectories,
            "visibilities": visibilities,
        }

    # ------------------------------------------------------------------
    def extract_query_points(self, images: np.ndarray,
                             query_masks: np.ndarray,
                             timesteps: np.ndarray) -> np.ndarray:
        """(t, x, y) query points [M, P, 3] sampled on the host."""
        pos = self._select_points(images, query_masks, timesteps,
                                  self.positive_point_selection_method,
                                  self.positive_points_per_mask)
        if self.negative_points_per_mask > 0:
            neg = self._select_points(images, 1.0 - query_masks, timesteps,
                                      self.negative_point_selection_method,
                                      self.negative_points_per_mask)
            xy = [np.concatenate([p, n], axis=0) for p, n in zip(pos, neg)]
        else:
            xy = pos
        xy = np.stack(xy, axis=0)
        ts = np.broadcast_to(timesteps[:, None, None], (*xy.shape[:2], 1))
        return np.concatenate([ts, xy], axis=2).astype(np.float32)

    def _select_points(self, images, masks, timesteps, method,
                       n) -> List[np.ndarray]:
        if method == "kmedoids":
            return [extract_kmedoid_points(m, n, rng=self.rng) for m in masks]
        if method == "shi-tomasi":
            return [extract_corner_points(images[int(t)], m, n, rng=self.rng)
                    for m, t in zip(masks, timesteps)]
        if method == "random":
            return [extract_random_mask_points(m, n, rng=self.rng)
                    for m in masks]
        if method == "mixed":
            return extract_mixed_points(list(masks), timesteps, images, n,
                                        rng=self.rng)
        raise NotImplementedError(f"Point selection method {method}")

    def _encode_all_frames(self, images_dev: torch.Tensor) -> torch.Tensor:
        """[T, H, W, 3] uint8 -> [T, g, g, 256], in chunks of
        `sam_encode_chunk` frames (the last padded with its final frame)."""
        t, h, w, _ = images_dev.shape
        ec = self.sam_encode_chunk
        chunks = []
        for i in range(0, t, ec):
            chunk = images_dev[i:i + ec]
            pad = ec - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1, -1)])
            emb = self.sam_predictor.encode_frames(chunk, (h, w))
            chunks.append(emb[:ec - pad])
        return torch.cat(chunks, dim=0)

    def _track_points_device(self, images_dev, query_points, hw):
        """Track in mask batches; mark points near the border OUTSIDE_FRAME.
        Returns trajectories [T, M, P, 2], visibilities [T, M, P]."""
        h, w = hw
        t = images_dev.shape[0]
        m, p, _ = query_points.shape
        bs = self.point_tracker_mask_batch_size
        video_b = images_dev[None]  # one object: the tracker's cache hits
        trajs, viss = [], []
        for i in range(0, m, bs):
            batch = query_points[i:i + bs].reshape(1, -1, 3)
            out_t, out_v = self.point_tracker.forward_device(video_b, batch)
            nb = min(bs, m - i)
            trajs.append(out_t[0].reshape(t, nb, p, 2))
            viss.append(out_v[0].reshape(t, nb, p))
        trajectories = torch.cat(trajs, dim=1).float()
        visibilities = torch.cat(viss, dim=1).float()
        x, y = trajectories[..., 0], trajectories[..., 1]
        oob = (x / w < 0.01) | (x / w > 0.99) | (y / h < 0.01) | (y / h > 0.99)
        visibilities = torch.where(
            oob, torch.full_like(visibilities,
                                 float(PointVisibilityType.OUTSIDE_FRAME)),
            visibilities)
        return trajectories, visibilities

    def _apply_sam_device(self, hw, trajectories, visibilities, embeddings):
        """Prompts, decode chain, IoU gating and scores for every (frame,
        mask) pair. Returns (logits [M, T, h, w], scores_per_frame [T, M])."""
        h, w = hw
        t, m = trajectories.shape[0], trajectories.shape[1]
        points, labels = build_prompts(
            trajectories, visibilities, self.positive_points_per_mask,
            self.negative_points_per_mask > 0,
            self.add_other_objects_positive_points_as_negative_points)
        n_prompt = points.shape[2]
        pts_flat = points.reshape(t * m, n_prompt, 2)
        lbl_flat = labels.reshape(t * m, n_prompt)
        emb_flat = torch.arange(t, device=points.device).repeat_interleave(m)
        has_visible = (lbl_flat != -1).any(dim=1)

        logits, iou_all = self._decode_all_pairs(embeddings, emb_flat,
                                                 pts_flat, lbl_flat, hw)
        passed = has_visible & (iou_all >= self.sam_iou_threshold)
        logits = self._gate_logits(logits, passed, t, m, h, w)
        scores_per_frame = torch.where(
            has_visible, iou_all,
            torch.full_like(iou_all, NEG_INF)).reshape(t, m)
        return logits, scores_per_frame

    def _decode_all_pairs(self, embeddings, emb_flat, pts_flat, lbl_flat,
                          hw):
        """Chunked decode chain over all pairs; the last chunk is padded to
        the full chunk size with copies of its first pair."""
        b = pts_flat.shape[0]
        chunk = min(self.sam_decode_chunk, b)
        device = pts_flat.device
        ups, ious = [], []
        for i in range(0, b, chunk):
            stop = min(i + chunk, b)
            nb = stop - i
            idx = torch.cat([torch.arange(i, stop, device=device),
                             torch.full((chunk - nb,), i, device=device)])
            up, iou = self._chain(embeddings[emb_flat[idx]], pts_flat[idx],
                                  lbl_flat[idx], hw)
            ups.append(up[:nb])
            ious.append(iou[:nb])
        return torch.cat(ups, dim=0), torch.cat(ious, dim=0)

    def _chain(self, emb, pts, lbl, hw):
        """The decode chain for one chunk of pairs -> (upscaled logits
        [B, h, w] in `logits_dtype`, iou [B])."""
        predictor = self.sam_predictor
        pts_model = predictor.scale_coords(pts, hw)
        if self.negative_points_per_mask > 0:
            pos_lbl = torch.where(lbl == 1, lbl, torch.full_like(lbl, -1))
            masks1, _ = predictor.decode(emb, pts_model, pos_lbl,
                                         only_token0=True)
            masks, iou = predictor.decode(emb, pts_model, lbl,
                                          masks1[:, 0, :, :, None],
                                          only_token0=True)
        else:
            masks, iou = predictor.decode(emb, pts_model, lbl,
                                          only_token0=True)
        low, iou = masks[:, 0], iou[:, 0]
        for _ in range(self.iterative_refinement_iterations):
            low, iou = self._box_refine(emb, pts_model, lbl, low, iou, hw)
        up = predictor.upscale_logits(low, hw)
        return up.to(self.logits_dtype), iou

    def _box_refine(self, emb, pts_model, lbl, low, iou, hw):
        """One box-refinement pass: the box is the extent of the full-res
        mask (logits > 0), passed as raw original-pixel corner coordinates
        (as the reference does); pairs whose mask has < 2 pixels keep their
        previous result."""
        predictor = self.sam_predictor
        mask = predictor.upscale_logits(low, hw) > 0  # [B, H, W]
        h, w = mask.shape[1], mask.shape[2]
        active = mask.sum(dim=(1, 2)) >= 2
        ys = torch.arange(h, dtype=torch.float32, device=mask.device)
        xs = torch.arange(w, dtype=torch.float32, device=mask.device)
        big = 1e9
        y_any = mask.any(dim=2)
        x_any = mask.any(dim=1)
        ymin = torch.where(y_any, ys, big).amin(dim=1)
        ymax = torch.where(y_any, ys, -big).amax(dim=1)
        xmin = torch.where(x_any, xs, big).amin(dim=1)
        xmax = torch.where(x_any, xs, -big).amax(dim=1)
        corners = torch.stack([xmin, ymin, xmax, ymax], dim=1).reshape(-1, 2, 2)
        corner_lbl = torch.where(
            active[:, None], torch.tensor([2, 3], device=lbl.device),
            torch.tensor(-1, device=lbl.device)).to(lbl.dtype)
        masks, new_iou = predictor.decode(
            emb, torch.cat([pts_model, corners], dim=1),
            torch.cat([lbl, corner_lbl], dim=1), low[..., None],
            torch.ones(low.shape[0], dtype=torch.bool, device=low.device),
            only_token0=True)
        low = torch.where(active[:, None, None], masks[:, 0], low)
        iou = torch.where(active, new_iou[:, 0], iou)
        return low, iou

    @staticmethod
    def _gate_logits(logits, passed, t, m, h, w):
        """-inf planes for failed pairs; layout [M, T, h, w]."""
        logits = torch.where(passed[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
        return logits.reshape(t, m, h, w).permute(1, 0, 2, 3)
