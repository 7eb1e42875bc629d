"""YouTube-VOS / YTVIS video instance segmentation AP evaluation: a copy
of `sam_pt_tpu/vis_eval/ytvos_eval.py`, held to it by
`tests/test_torch_ytvos_eval.py`.

Native re-implementation of the reference's vendored YTVOS API
(sam_pt/vis_eval/mask2former_video/data_video/datasets/ytvis_api/
ytvoseval.py:85-546 — COCO-style video AP), with the full COCO semantics:

- spatio-temporal track IoU: per-frame intersections and unions summed over
  time; a frame where only one side has a mask contributes that mask's area
  to the union (iou_seq, reference :204-225);
- object "size" = avg_area, the mean of NONZERO per-frame areas (:103-106);
- area ranges all/small/medium/large = [0,1e10]/[0,128^2]/[128^2,256^2]/
  [256^2,1e10] (:546), maxDets = [1, 10, 100] (:545);
- COCO matching per IoU threshold .5:.05:.95: detections in score order
  greedily take the best not-yet-taken GT (crowd GT may be re-matched),
  preferring non-ignored GTs; GTs that are crowd or out of area range are
  ignored, detections matched to ignored GTs — or unmatched and themselves
  out of range — are ignored (:286-334);
- accumulate: monotone precision envelope + 101-point interpolation per
  (threshold, category, area, maxDet), recall = final recall (:360-447);
- summarize: AP, AP50, AP75, APs, APm, APl, AR@1, AR@10, AR@100, ARs, ARm,
  ARl, each a mean over entries > -1 (absent categories excluded, :462-506).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .rle import segmentation_to_mask

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 128.0 ** 2),
    "medium": (128.0 ** 2, 256.0 ** 2),
    "large": (256.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def track_iou(det_masks: List[Optional[np.ndarray]],
              gt_masks: List[Optional[np.ndarray]]) -> float:
    """Spatio-temporal IoU between two mask tracks (lists over frames)."""
    inter = 0.0
    union = 0.0
    for d, g in zip(det_masks, gt_masks):
        if d is None and g is None:
            continue
        if d is None:
            union += g.sum()
        elif g is None:
            union += d.sum()
        else:
            inter += np.logical_and(d, g).sum()
            union += np.logical_or(d, g).sum()
    return float(inter / union) if union > 0 else 0.0


def avg_area(masks: List[Optional[np.ndarray]]) -> float:
    """Mean of NONZERO per-frame mask areas (reference avg_area :103-106)."""
    areas = [float(m.sum()) for m in masks if m is not None]
    areas = [a for a in areas if a > 0]
    return float(np.mean(areas)) if areas else 0.0


def _match_video(ious: np.ndarray, gt_ignore: np.ndarray,
                 gt_crowd: np.ndarray, det_out_of_rng: np.ndarray):
    """COCO greedy matching for one (video, category, area range).

    ious: [D, G] with detections already in descending score order and GTs
    sorted ignored-last. Returns (dt_matched [T, D] bool, dt_ignore [T, D]
    bool, gt_matched [T, G] bool).
    """
    n_thr = len(IOU_THRS)
    n_det, n_gt = ious.shape
    dtm = np.zeros((n_thr, n_det), bool)
    dti = np.zeros((n_thr, n_det), bool)
    gtm = np.zeros((n_thr, n_gt), bool)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(n_det):
            best = min(thr, 1.0 - 1e-10)
            match = -1
            for gi in range(n_gt):
                if gtm[ti, gi] and not gt_crowd[gi]:
                    continue  # taken, and crowds may be re-matched
                if match > -1 and not gt_ignore[match] and gt_ignore[gi]:
                    break  # already matched to a real GT; ignores are sorted last
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                match = gi
            if match == -1:
                continue
            dtm[ti, di] = True
            dti[ti, di] = gt_ignore[match]
            gtm[ti, match] = True
    # unmatched detections outside the area range are ignored, not FPs
    dti |= (~dtm) & det_out_of_rng[None, :]
    return dtm, dti, gtm


class YTVOSEvaluator:
    """Evaluate detection records against a YTVIS-format GT dict.

    gt: {'videos': [{id, height, width, length, file_names}],
         'annotations': [{id, video_id, category_id, segmentations, iscrowd}],
         'categories': [{id, name}]}
    detections: [{video_id, category_id, score, segmentations}] where
    segmentations is a per-frame list of RLE dicts (or None).
    """

    def __init__(self, gt: Dict, max_dets: int = 100):
        self.gt = gt
        self.max_dets = max_dets
        self.max_dets_ladder = tuple(m for m in MAX_DETS if m <= max_dets)
        if max_dets not in self.max_dets_ladder:
            self.max_dets_ladder += (max_dets,)
        self.video_hw = {
            v["id"]: (v["height"], v["width"]) for v in gt["videos"]
        }

    def _decode_track(self, segs, hw):
        return [
            None if s is None else segmentation_to_mask(s, hw) for s in segs
        ]

    def evaluate(self, detections: List[Dict],
                 class_agnostic: bool = False) -> Dict[str, float]:
        cats = sorted({c["id"] for c in self.gt["categories"]})
        if class_agnostic:
            cats = [0]
        cat_of = (lambda c: 0) if class_agnostic else (lambda c: c)

        gt_index = defaultdict(list)
        for ann in self.gt["annotations"]:
            gt_index[(ann["video_id"], cat_of(ann["category_id"]))].append(ann)
        det_index = defaultdict(list)
        for det in detections:
            det_index[(det["video_id"], cat_of(det["category_id"]))].append(det)

        videos = [v["id"] for v in self.gt["videos"]]
        area_names = list(AREA_RNG)
        n_thr, n_area = len(IOU_THRS), len(area_names)
        n_md = len(self.max_dets_ladder)

        # per (cat): accumulate per-video match tables, then reduce
        precision = -np.ones((n_thr, len(REC_THRS), len(cats), n_area, n_md))
        recall = -np.ones((n_thr, len(cats), n_area, n_md))

        for ki, cat in enumerate(cats):
            # ---- stage 1: per-video IoUs + per-area matching
            per_video = []  # (scores [D], dtm/dti [A, T, D], gt_ig [A, G])
            for vid in videos:
                hw = self.video_hw[vid]
                gts = gt_index.get((vid, cat), [])
                dets = sorted(det_index.get((vid, cat), []),
                              key=lambda d: -d["score"])[: self.max_dets]
                if not gts and not dets:
                    continue
                gt_tracks = [
                    self._decode_track(g["segmentations"], hw) for g in gts
                ]
                det_tracks = [
                    self._decode_track(d["segmentations"], hw) for d in dets
                ]
                gt_area = np.array([avg_area(t) for t in gt_tracks])
                det_area = np.array([avg_area(t) for t in det_tracks])
                gt_crowd = np.array(
                    [bool(g.get("iscrowd", 0)) for g in gts], bool
                )

                ious = np.zeros((len(dets), len(gts)))
                for i, dt in enumerate(det_tracks):
                    for j, gtt in enumerate(gt_tracks):
                        ious[i, j] = track_iou(dt, gtt)

                dtm_a = np.zeros((n_area, n_thr, len(dets)), bool)
                dti_a = np.zeros((n_area, n_thr, len(dets)), bool)
                gti_a = np.zeros((n_area, len(gts)), bool)
                for ai, aname in enumerate(area_names):
                    lo, hi = AREA_RNG[aname]
                    gt_ig = gt_crowd | (gt_area < lo) | (gt_area > hi)
                    det_oor = (det_area < lo) | (det_area > hi)
                    # sort GTs ignored-last (stable), as matching requires
                    order = np.argsort(gt_ig, kind="stable")
                    dtm, dti, _ = _match_video(
                        ious[:, order], gt_ig[order], gt_crowd[order], det_oor
                    )
                    dtm_a[ai], dti_a[ai] = dtm, dti
                    gti_a[ai] = gt_ig
                per_video.append(
                    (np.array([d["score"] for d in dets]), dtm_a, dti_a, gti_a)
                )

            # ---- stage 2: accumulate over videos per (area, maxDet)
            for ai in range(n_area):
                for mi, md in enumerate(self.max_dets_ladder):
                    scores = np.concatenate(
                        [pv[0][:md] for pv in per_video]
                    ) if per_video else np.zeros((0,))
                    dtm = np.concatenate(
                        [pv[1][ai][:, :md] for pv in per_video], axis=1
                    ) if per_video else np.zeros((n_thr, 0), bool)
                    dti = np.concatenate(
                        [pv[2][ai][:, :md] for pv in per_video], axis=1
                    ) if per_video else np.zeros((n_thr, 0), bool)
                    n_gt = int(sum((~pv[3][ai]).sum() for pv in per_video))
                    if n_gt == 0:
                        continue  # category absent in this range: stays -1
                    order = np.argsort(-scores, kind="mergesort")
                    dtm, dti = dtm[:, order], dti[:, order]
                    tps = dtm & ~dti
                    fps = ~dtm & ~dti
                    tp = np.cumsum(tps, axis=1).astype(np.float64)
                    fp = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(n_thr):
                        rc = tp[ti] / n_gt
                        pr = tp[ti] / np.maximum(tp[ti] + fp[ti], 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if rc.size else 0.0
                        # monotone envelope + 101-point interpolation
                        for k in range(len(pr) - 1, 0, -1):
                            pr[k - 1] = max(pr[k - 1], pr[k])
                        idx = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        precision[ti, :, ki, ai, mi] = q

        def _mean(x):
            vals = x[x > -1]
            return float(vals.mean()) if vals.size else -1.0

        mi_full = self.max_dets_ladder.index(
            self.max_dets_ladder[-1]
        )
        a_all = area_names.index("all")
        out = {
            "AP": _mean(precision[:, :, :, a_all, mi_full]),
            "AP50": _mean(precision[0, :, :, a_all, mi_full]),
            "AP75": _mean(precision[5, :, :, a_all, mi_full]),
            "APs": _mean(precision[:, :, :, area_names.index("small"), mi_full]),
            "APm": _mean(precision[:, :, :, area_names.index("medium"), mi_full]),
            "APl": _mean(precision[:, :, :, area_names.index("large"), mi_full]),
        }
        for mi, md in enumerate(self.max_dets_ladder):
            out[f"AR@{md}"] = _mean(recall[:, :, a_all, mi])
        out["ARs"] = _mean(recall[:, :, area_names.index("small"), mi_full])
        out["ARm"] = _mean(recall[:, :, area_names.index("medium"), mi_full])
        out["ARl"] = _mean(recall[:, :, area_names.index("large"), mi_full])
        return out
