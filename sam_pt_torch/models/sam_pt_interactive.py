"""Simulated interactive point correction against ground-truth masks
(counterpart of `sam_pt_tpu/models/sam_pt_interactive.py`; reference
sam_pt/modeling/sam_pt_interactive.py).

The frames are encoded once. The correction loop walks the frames under an
interaction budget: on a frame whose IoU with the ground truth is below the
current threshold it removes the first wrong visible negative (then
positive) point from that frame on, or else adds a point at the largest
DBSCAN cluster of the larger of the false-negative and false-positive
regions and tracks it from that frame on. Offline mode sweeps a ladder of
IoU thresholds and falls back to the best pass; online mode uses one
threshold. The history is written as JSON and pickles, with a plot where
matplotlib is installed.

Every decode, of one frame or of all, goes through one chain with a prompt
of fixed capacity (initial points + interaction budget; pad slots are
masked out of the decoder's token attention): a positives-only pass, an
all-points pass with its mask as input (kept where the prompt has a
negative), then the box-refinement passes, run unconditionally (the JAX
package stops them at the exact fixed point, which gives the same output).
"""
from __future__ import annotations

import json
import os
import pickle
from collections import Counter, namedtuple
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.resize import resize_planes
from ..utils.dbscan import dbscan
from ..utils.query_points import kmedoids
from ..vos_eval.metrics import db_eval_boundary, db_eval_iou
from .sam_pt import SamPt

HistoryEntry = namedtuple(
    "HistoryEntry",
    "action type frame_idx point_idx iou_before iou_after interaction_idx "
    "current_iou_threshold overall_iou_before overall_iou_after "
    "boundary_score_before boundary_score_after "
    "overall_boundary_score_before overall_boundary_score_after "
    "jf_score_before jf_score_after",
)

OFFLINE_IOU_THRESHOLDS = [
    0.10, 0.20, 0.30, 0.40, 0.50, 0.60, 0.65, 0.70, 0.75, 0.80,
    0.85, 0.88, 0.90, 0.92, 0.95,
]


def extract_largest_cluster_points(
    mask: np.ndarray,
    n_points_to_select: int,
    dbscan_points: int = 18000,
    db_largest_cluster_min_points: int = 180,
    kmedian_points: int = 720,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """K-medoids points (x, y) [n, 2] inside the largest DBSCAN cluster of
    the mask (eps = 2.4 * H * W / dbscan_points, min_samples 10), or of the
    whole mask when there is no cluster or it is small."""
    rng = rng or np.random.default_rng()
    pix = np.stack(np.nonzero(mask), axis=-1).astype(np.float32)  # (y, x)
    assert len(pix) > 0
    sub = pix[rng.permutation(len(pix))[:dbscan_points]]

    eps = 2.4 * (mask.shape[0] * mask.shape[1]) / dbscan_points
    labels, _ = dbscan(sub, eps, min_samples=10)
    counts = Counter(labels.tolist())
    counts.pop(-1, None)
    if not counts:
        cluster = pix
    else:
        cid = counts.most_common(1)[0][0]
        cluster = sub[labels == cid]
        if len(cluster) < db_largest_cluster_min_points:
            cluster = pix

    cluster = cluster[rng.permutation(len(cluster))[:kmedian_points]]
    k = min(n_points_to_select, len(cluster))
    sel = kmedoids(cluster, k, rng)
    if k < n_points_to_select:
        sel = np.tile(sel, (int(np.ceil(n_points_to_select / k)), 1))[
            :n_points_to_select]
    return sel[:, ::-1].copy()  # (x, y)


class SamPtInteractive(SamPt):
    def __init__(
        self,
        interactions_max: int = 300,
        interactions_max_per_frame: int = 3,
        online_interactive_iou_threshold: float = 0.9,
        disable_point_tracking: bool = False,
        online: bool = False,
        output_root: str = "interactions",
        save_history: bool = True,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.interactions_max = interactions_max
        self.interactions_max_per_frame = interactions_max_per_frame
        self.online_interactive_iou_threshold = online_interactive_iou_threshold
        self.disable_point_tracking = disable_point_tracking
        self.online = online
        self.output_root = output_root
        self.save_history = save_history
        # Decode chains run (each over one chunk of pairs) since this was
        # last set to 0, for inspection.
        self.chain_calls = 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, video: Dict) -> Dict:
        """video: 'image' [T, H, W, 3] (or [T, 3, H, W]) uint8, 'target_hw',
        one object's 'query_masks' [1, H, W] with 'query_point_timestep'
        [1] (or 'query_points' [1, P, 3]), and 'gt_masks' (T masks of
        H x W). Returns device tensors logits [1, T, h, w] float16 (zero
        where no positive point is visible), scores [1], scores_per_frame
        [T, 1], trajectories [T, 1, P', 2], visibilities [T, 1, P'], with
        the 'interaction_history' and the 'final_ious'."""
        images = np.asarray(video["image"])
        if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
            images = np.ascontiguousarray(images.transpose(0, 2, 3, 1))
        if images.dtype != np.uint8:
            raise ValueError("input images must be uint8 (0-255)")
        t, h, w, _ = images.shape

        if video.get("query_masks") is not None:
            query_masks = np.asarray(video["query_masks"], np.float32)
            timesteps = np.asarray(video["query_point_timestep"], np.float32)
            query_points = self.extract_query_points(images, query_masks,
                                                     timesteps)
        elif video.get("query_points") is not None:
            query_points = np.asarray(video["query_points"], np.float32)
        else:
            raise ValueError("no query points or masks given")
        n_masks, n_ppm, _ = query_points.shape
        assert n_masks == 1, "Interactive correction works with a single mask"
        assert "gt_masks" in video, "GT masks required for interactive correction"
        gt_masks = np.asarray(video["gt_masks"]).reshape(t, h, w) > 0.5

        thresholds = ([self.online_interactive_iou_threshold] if self.online
                      else list(OFFLINE_IOU_THRESHOLDS))
        interactions_max = self.interactions_max
        interactions_left = interactions_max
        if self.disable_point_tracking:
            thresholds = [1.0]
            interactions_max = self.interactions_max_per_frame * t
            interactions_left = interactions_max

        images_dev = torch.from_numpy(images).to(self.device)
        embeddings = self._embed(images_dev)
        capacity = n_ppm + interactions_max

        if self.disable_point_tracking:
            trajectories = np.zeros((t, 1, 1, 2), np.float32)
            visibilities = np.zeros((t, 1, 1), np.float32)
            point_labels = np.ones((1,), np.int64)
        else:
            trajectories, visibilities = self._track_points(images_dev,
                                                            query_points)
            point_labels = np.ones((n_ppm,), np.int64)
            point_labels[self.positive_points_per_mask:] = 0
            interactions_left -= n_ppm

        def predict_frames(frame_idxs, traj, vis, labels):
            return self._predict_frames(embeddings, (h, w), capacity,
                                        frame_idxs, traj, vis, labels)

        def frame_metrics(frame_idx, traj, vis, labels):
            logits, _ = predict_frames([frame_idx], traj, vis, labels)
            m = logits[0] > 0
            gt = gt_masks[frame_idx]
            return (m, gt, float(db_eval_iou(gt, m)),
                    float(db_eval_boundary(gt, m)))

        def full_pass(traj, vis, labels):
            logits, scores_pf = predict_frames(list(range(t)), traj, vis,
                                               labels)
            ious = [float(db_eval_iou(gt_masks[f], logits[f] > 0))
                    for f in range(t)]
            bss = [float(db_eval_boundary(gt_masks[f], logits[f] > 0))
                   for f in range(t)]
            return logits, scores_pf, ious, bss

        cache = []
        history: List[HistoryEntry] = []
        current_threshold = thresholds.pop(0)
        pass_ious: List[float] = []
        pass_bss: List[float] = []
        frame_idx = 0
        frame_interactions = 0
        # The all-frames sweeps before and after each interaction feed only
        # the history, never the control flow, so they run only when the
        # history is kept.
        track_overall = self.save_history
        if track_overall:
            _, _, prev_ious, prev_bss = full_pass(trajectories, visibilities,
                                                  point_labels)
            prev_iou = float(np.mean(prev_ious))
            prev_bs = float(np.mean(prev_bss))
        else:
            prev_iou = prev_bs = float("nan")

        while interactions_left > 0:
            if frame_idx == t:
                cache.append({
                    "current_threshold": current_threshold,
                    "trajectories": trajectories.copy(),
                    "visibilities": visibilities.copy(),
                    "point_labels": point_labels.copy(),
                    "interactions_left": interactions_left,
                    "average_iou": float(np.mean(pass_ious)),
                    "average_boundary_score": float(np.mean(pass_bss)),
                    "current_pass_ious": list(pass_ious),
                    "current_pass_boundary_scores": list(pass_bss),
                })
                if not thresholds:
                    break
                current_threshold = thresholds.pop(0)
                frame_idx = 0
                frame_interactions = 0
                pass_ious, pass_bss = [], []

            m, gt, iou, boundary = frame_metrics(
                frame_idx, trajectories, visibilities, point_labels)
            if iou >= current_threshold:
                frame_idx += 1
                frame_interactions = 0
                pass_ious.append(iou)
                pass_bss.append(boundary)
                continue

            fp_mask = m & ~gt
            fn_mask = ~m & gt

            incorrect_neg, incorrect_pos = [], []
            for pi in range(trajectories.shape[2]):
                if visibilities[frame_idx, 0, pi] != 1:
                    continue
                x, y = np.round(trajectories[frame_idx, 0, pi]).astype(int)
                x = np.clip(x, 0, w - 1)
                y = np.clip(y, 0, h - 1)
                positive = point_labels[pi] == 1
                # A positive point is right on the object, a negative one
                # off it, whatever the prediction there.
                correct = bool(gt[y, x]) == bool(positive)
                if not correct:
                    (incorrect_pos if positive else incorrect_neg).append(pi)

            if incorrect_neg:
                pi = incorrect_neg[0]
                visibilities[frame_idx:, 0, pi] = 0
                action, a_type, a_pi = "remove", "negative", pi
            elif incorrect_pos:
                pi = incorrect_pos[0]
                visibilities[frame_idx:, 0, pi] = 0
                action, a_type, a_pi = "remove", "positive", pi
            else:
                action = "add"
                a_pi = trajectories.shape[2]
                if fn_mask.sum() > fp_mask.sum():
                    mask, label, a_type = fn_mask, 1, "positive"
                else:
                    mask, label, a_type = fp_mask, 0, "negative"
                assert mask.sum() > 0
                xy = extract_largest_cluster_points(
                    mask, min(3, int(mask.sum())), rng=self.rng)[0]
                x, y = float(xy[0]), float(xy[1])
                new_traj = np.zeros((t, 1, 1, 2), np.float32)
                new_vis = np.zeros((t, 1, 1), np.float32)
                if self.disable_point_tracking:
                    new_traj[frame_idx, 0, 0] = (x, y)
                    new_vis[frame_idx, 0, 0] = 1
                else:
                    qp_new = np.array([[[0, x, y]]], np.float32)
                    tr, vi = self._track_points(images_dev[frame_idx:],
                                                qp_new)
                    tr[0, 0, 0] = (x, y)
                    vi[0, 0, 0] = 1
                    new_traj[frame_idx:] = tr
                    new_vis[frame_idx:] = vi
                trajectories = np.concatenate([trajectories, new_traj], axis=2)
                visibilities = np.concatenate([visibilities, new_vis], axis=2)
                point_labels = np.concatenate([point_labels, [label]])

            _, _, iou_after, bs_after = frame_metrics(
                frame_idx, trajectories, visibilities, point_labels)
            if not track_overall:
                next_iou, next_bs = prev_iou, prev_bs
            else:
                _, _, ni, nb = full_pass(trajectories, visibilities,
                                         point_labels)
                next_iou, next_bs = float(np.mean(ni)), float(np.mean(nb))

            history.append(HistoryEntry(
                action=action, type=a_type, frame_idx=frame_idx,
                point_idx=int(a_pi), iou_before=iou, iou_after=iou_after,
                interaction_idx=interactions_left,
                current_iou_threshold=current_threshold,
                overall_iou_before=prev_iou, overall_iou_after=next_iou,
                boundary_score_before=boundary, boundary_score_after=bs_after,
                overall_boundary_score_before=prev_bs,
                overall_boundary_score_after=next_bs,
                jf_score_before=(prev_iou + prev_bs) / 2,
                jf_score_after=(next_iou + next_bs) / 2,
            ))

            interactions_left -= 1
            frame_interactions += 1
            prev_iou, prev_bs = next_iou, next_bs
            if (iou_after >= current_threshold
                    or frame_interactions >= self.interactions_max_per_frame):
                frame_idx += 1
                frame_interactions = 0
                pass_ious.append(iou_after)
                pass_bss.append(bs_after)

        # The final pass, or the best cached threshold's if it scored more.
        logits, scores_pf, final_ious, _ = full_pass(
            trajectories, visibilities, point_labels)
        if cache:
            best = max(cache, key=lambda x: x["average_iou"])
            if best["average_iou"] > float(np.mean(final_ious)):
                trajectories = best["trajectories"]
                visibilities = best["visibilities"]
                point_labels = best["point_labels"]
                logits, scores_pf, final_ious, _ = full_pass(
                    trajectories, visibilities, point_labels)

        if self.save_history:
            self._dump_history(video, history, cache, trajectories,
                               visibilities, point_labels, logits)

        device = self.device
        target_hw = tuple(video["target_hw"])
        out_logits = torch.from_numpy(logits).to(device)[None]
        if (h, w) != target_hw:
            out_logits = resize_planes(out_logits, target_hw)
        resize = torch.tensor([target_hw[1] / w, target_hw[0] / h],
                              device=device)
        finite = scores_pf[np.isfinite(scores_pf)]
        score = float(np.mean(finite)) if finite.size else float("nan")
        return {
            "logits": out_logits.to(torch.float16),
            "scores": torch.tensor([score], device=device),
            "scores_per_frame": torch.from_numpy(scores_pf[:, None]).to(device),
            "trajectories": torch.from_numpy(trajectories).to(device) * resize,
            "visibilities": torch.from_numpy(visibilities).to(device),
            "interaction_history": [e._asdict() for e in history],
            "final_ious": final_ious,
        }

    # ------------------------------------------------------------------
    def _predict_frames(self, embeddings, hw, capacity, frame_idxs, traj,
                        vis, labels):
        """Decode `frame_idxs` with the visible points of one object packed
        into a prompt of `capacity` slots (label -1 past them). Returns
        numpy (logits [len, H, W] float32, IoU scores [len]); frames with no
        visible positive point get zero logits and scores."""
        n_frames = len(frame_idxs)
        pts = np.zeros((n_frames, capacity, 2), np.float32)
        lbl = np.full((n_frames, capacity), -1, np.int64)
        for bi, f in enumerate(frame_idxs):
            visible = vis[f, 0] == 1
            k = int(visible.sum())
            pts[bi, :k] = traj[f, 0][visible]
            lbl[bi, :k] = labels[visible]
        has_pos = (lbl == 1).any(axis=1)

        device = self.device
        logits, iou = self._decode_all_pairs(
            embeddings, torch.as_tensor(frame_idxs, device=device),
            torch.from_numpy(pts).to(device), torch.from_numpy(lbl).to(device),
            hw, chain=self._interactive_chain)
        logits = logits.float().cpu().numpy()
        scores = iou.float().cpu().numpy()
        logits[~has_pos] = 0.0
        scores[~has_pos] = 0.0
        return logits, scores

    def _interactive_chain(self, emb, pts, lbl, hw):
        """One chunk of pairs -> (upscaled logits [B, H, W] float32, iou
        [B]): the positives-only pass, the all-points pass with its mask
        as input where the prompt has a negative, the box refinements."""
        self.chain_calls += 1
        predictor = self.sam_predictor
        pts_model = predictor.scale_coords(pts, hw)
        pos_lbl = torch.where(lbl == 1, lbl, torch.full_like(lbl, -1))
        masks, iou = predictor.decode(emb, pts_model, pos_lbl,
                                      only_token0=True)
        low, iou = masks[:, 0], iou[:, 0]
        masks, iou2 = predictor.decode(emb, pts_model, lbl, low[..., None],
                                       only_token0=True)
        has_neg = (lbl == 0).any(dim=1)
        low = torch.where(has_neg[:, None, None], masks[:, 0], low)
        iou = torch.where(has_neg, iou2[:, 0], iou)
        for _ in range(self.iterative_refinement_iterations):
            low, iou = self._box_refine(emb, pts_model, lbl, low, iou, hw)
        return predictor.upscale_logits(low, hw), iou

    def _dump_history(self, video, history, cache, trajectories,
                      visibilities, point_labels, logits):
        """history.json, the threshold cache and the final state as
        pickles, and the IoU plot where matplotlib is installed, under
        `output_root`/<video id>."""
        root = os.path.join(self.output_root, str(video.get("video_id", 0)))
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "history.json"), "w") as f:
            json.dump([e._asdict() for e in history], f, indent=4)
        with open(os.path.join(root, "achieved_iou_thresholds_cache.pkl"),
                  "wb") as f:
            pickle.dump(cache, f)
        with open(os.path.join(root, "final.pkl"), "wb") as f:
            pickle.dump({"trajectories": trajectories,
                         "visibilities": visibilities,
                         "point_labels": point_labels, "logits": logits}, f)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(10, 5))
            plt.plot([e.current_iou_threshold for e in history],
                     label="Threshold")
            plt.plot([e.overall_iou_before for e in history], label="Before")
            plt.plot([e.overall_iou_after for e in history], label="After")
            plt.xlabel("Interaction")
            plt.ylabel("IoU")
            plt.legend()
            plt.tight_layout()
            plt.savefig(os.path.join(root, "overall_iou_history.png"))
            plt.close()
        except Exception:
            pass
