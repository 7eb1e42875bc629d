"""Automatic mask generation from a point grid (counterpart of
`sam_pt_tpu/models/sam/auto_mask_generator.py`, the `segment_anything`
SamAutomaticMaskGenerator that the VIS adapter calls; defaults of
configs/vis_eval_root.yaml: a 32 x 32 grid, batches of 64, predicted-IoU
gate 0.88, stability gate 0.95 with offset 1.0, box NMS 0.7, no crop
layers).

Per crop, the image is encoded once (with HQ-SAM, its decoder's
image-level features made once too); the grid is decoded in batches of
`points_per_batch` one-point prompts with multimask output, the embedding
broadcast over the batch by `expand` (part by part where it has parts).
Both gates run on the device: the predicted IoU (`>`) and the stability
score, the ratio of two integer pixel counts of the
low-resolution logits taken in float64 (`>=`). Only the survivors are
upscaled and thresholded there, and come to the host as bool masks. Their
boxes, the greedy box NMS (within and between crops) and the small-region
clean-up (`scipy.ndimage.label`, 8-connected) run on the host, in the JAX
package's order and with its tie rules.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.tree import tree_map
from .predictor import SamPredictor

# 8-connected neighbourhoods, as cv2.connectedComponentsWithStats(..., 8).
_EIGHT_CONNECTED = np.ones((3, 3), bool)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized (x, y) grid with half-cell offset (SAM layout)."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1.0 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


def mask_to_box(mask: np.ndarray) -> np.ndarray:
    """Binary [H, W] -> XYXY box (zeros if empty), from the rows and
    columns that hold a pixel."""
    rows = np.flatnonzero(mask.any(axis=1))
    if len(rows) == 0:
        return np.zeros((4,), np.float32)
    cols = np.flatnonzero(mask.any(axis=0))
    return np.array([cols[0], rows[0], cols[-1] + 1, rows[-1] + 1],
                    np.float32)


def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_thresh: float) -> np.ndarray:
    """Greedy NMS; returns kept indices (torchvision.ops.nms semantics,
    ties in score kept in input order)."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    while len(order) > 0:
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


class SamAutomaticMaskGenerator:
    def __init__(
        self,
        model: SamPredictor,
        points_per_side: int = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
    ):
        self.predictor = model
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        if point_grids is None:
            self.point_grids = [
                build_point_grid(
                    max(1, points_per_side // (crop_n_points_downscale_factor ** i))
                )
                for i in range(crop_n_layers + 1)
            ]
        else:
            self.point_grids = point_grids

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image [H, W, 3] uint8 RGB -> list of mask records (SAM schema),
        largest first."""
        h, w = image.shape[:2]
        crop_groups = [
            self._generate_for_crop(image, (0, 0, w, h), self.point_grids[0],
                                    (h, w))
        ]
        for layer in range(1, self.crop_n_layers + 1):
            for crop_box in self._crop_boxes(h, w, layer):
                x0, y0, x1, y1 = crop_box
                crop_groups.append(self._generate_for_crop(
                    image[y0:y1, x0:x1], crop_box, self.point_grids[layer],
                    (h, w)))

        # within-crop NMS on predicted IoU (segment_anything _process_crop)
        records: List[Dict] = []
        for recs in crop_groups:
            if not recs:
                continue
            boxes = np.stack([r["bbox_xyxy"] for r in recs])
            scores = np.array([r["predicted_iou"] for r in recs])
            keep = box_nms(boxes, scores, self.box_nms_thresh)
            records.extend(recs[i] for i in keep)
        if not records:
            return []

        # between-crop NMS: prefer masks from smaller crops (score =
        # 1 / crop area, segment_anything generate_masks semantics)
        if len(crop_groups) > 1:
            boxes = np.stack([r["bbox_xyxy"] for r in records])
            scores = np.array([
                1.0 / max(r["crop_box"][2] * r["crop_box"][3], 1)
                for r in records
            ])
            keep = box_nms(boxes, scores, self.crop_nms_thresh)
            records = [records[i] for i in keep]

        if self.min_mask_region_area > 0:
            records = self._postprocess_small_regions(records)

        out = []
        for r in records:
            x0, y0, x1, y1 = r.pop("bbox_xyxy")
            r["bbox"] = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            r["area"] = int(r["segmentation"].sum())
            out.append(r)
        out.sort(key=lambda r: -r["area"])
        return out

    # ------------------------------------------------------------------
    # The stages of a crop, each a method (chip_smoke.py times them).
    def _encode(self, image: np.ndarray):
        """[h, w, 3] uint8 -> the decode-ready embedding of one frame, on
        the device."""
        frame = torch.from_numpy(np.ascontiguousarray(image[None])).to(
            self.predictor.model.device)
        return self.predictor.decode_ready(
            self.predictor.encode_frames(frame, image.shape[:2]))

    def _decode(self, emb, points: np.ndarray, hw: Tuple[int, int]):
        """One batch of one-point prompts [B, 2] (original pixels) ->
        (low-res logits [3B, 4g, 4g], predicted IoU [3B]) of SAM's three
        multimask tokens, pair-major, on the device."""
        bs = points.shape[0]
        device = self.predictor.model.device
        emb_b = tree_map(lambda e: e.expand(bs, *e.shape[1:]), emb)
        labels = torch.ones((bs, 1), dtype=torch.long, device=device)
        low, iou, _ = self.predictor.predict(
            emb_b, torch.from_numpy(points[:, None, :]).to(device), labels,
            hw, multimask_output=True)
        return low.reshape(-1, *low.shape[2:]), iou.reshape(-1)

    def _gate_and_upscale(self, low: torch.Tensor, iou: torch.Tensor,
                          hw: Tuple[int, int]):
        """The IoU and stability gates on the device, then the survivors
        upscaled and thresholded there. Returns numpy (indices, bool masks
        [K, h, w], IoUs, stability scores in float64), or None if nothing
        passed."""
        mt = self.predictor.model.mask_threshold
        off = self.stability_score_offset
        hi = (low > mt + off).sum(dim=(1, 2))
        lo = (low > mt - off).sum(dim=(1, 2))
        stability = hi.double() / lo.clamp(min=1).double()
        passed = (iou > self.pred_iou_thresh) & (
            stability >= self.stability_score_thresh)
        idx = torch.nonzero(passed).flatten()
        if idx.numel() == 0:
            return None
        masks = self.predictor.upscale_logits(low[idx], hw) > mt
        return (idx.cpu().numpy(), masks.cpu().numpy(),
                iou[idx].cpu().numpy(), stability[idx].cpu().numpy())

    def _records(self, masks, ious, stability, points, crop_box,
                 full_hw) -> List[Dict]:
        """Host records of the survivors: box, crop offsets, scores."""
        x0, y0, x1, y1 = crop_box
        out = []
        for m, s, p, st in zip(masks, ious, points, stability):
            box = mask_to_box(m)
            if not m.any():
                continue
            out.append({
                "segmentation": self._offset_mask(m, crop_box, full_hw),
                "bbox_xyxy": box + np.array([x0, y0, x0, y0], np.float32),
                "predicted_iou": float(s),
                "point_coords": [[float(p[0] + x0), float(p[1] + y0)]],
                "stability_score": float(st),
                "crop_box": [x0, y0, x1 - x0, y1 - y0],
            })
        return out

    # ------------------------------------------------------------------
    def _generate_for_crop(self, image, crop_box, grid, full_hw) -> List[Dict]:
        h, w = image.shape[:2]
        emb = self._encode(image)
        pts_all = grid * np.array([w, h], np.float32)
        bs = self.points_per_batch
        kept: List[Dict] = []
        for i in range(0, len(pts_all), bs):
            chunk = pts_all[i:i + bs]
            n = 3 * len(chunk)  # the short last batch is padded, then cut
            if len(chunk) < bs:
                chunk = np.concatenate(
                    [chunk, np.zeros((bs - len(chunk), 2), np.float32)])
            low, iou = self._decode(emb, chunk, (h, w))
            found = self._gate_and_upscale(low[:n], iou[:n], (h, w))
            if found is None:
                continue
            idx, masks, ious, stability = found
            src_pts = np.repeat(chunk, 3, axis=0)[idx]
            kept.extend(self._records(masks, ious, stability, src_pts,
                                      crop_box, full_hw))
        return kept

    @staticmethod
    def _offset_mask(mask, crop_box, full_hw):
        """Place a crop-local mask onto the full-image canvas so every
        record's segmentation has the same (H, W) shape."""
        x0, y0, x1, y1 = crop_box
        fh, fw = full_hw
        if mask.shape == (fh, fw):
            return mask
        full = np.zeros((fh, fw), bool)
        full[y0:y0 + mask.shape[0], x0:x0 + mask.shape[1]] = mask
        return full

    def _crop_boxes(self, h, w, layer):
        n = 2 ** layer
        overlap = int(self.crop_overlap_ratio * min(h, w) * 2 / n)
        boxes = []
        cw = int((w + overlap * (n - 1)) / n + 0.5)
        ch = int((h + overlap * (n - 1)) / n + 0.5)
        for i in range(n):
            for j in range(n):
                x0 = max(0, j * (cw - overlap))
                y0 = max(0, i * (ch - overlap))
                boxes.append((x0, y0, min(x0 + cw, w), min(y0 + ch, h)))
        return boxes

    def _remove_small(self, m: np.ndarray, holes: bool
                      ) -> Tuple[np.ndarray, bool]:
        """Zero the 8-connected regions of `m` (of its complement, with
        `holes`) smaller than `min_mask_region_area`; whether any was."""
        from scipy import ndimage

        work = ~m if holes else m.copy()
        labels, _ = ndimage.label(work, structure=_EIGHT_CONNECTED)
        areas = np.bincount(labels.ravel())
        small = np.flatnonzero(areas < self.min_mask_region_area)
        small = small[small > 0]
        if len(small):
            work[np.isin(labels, small)] = False
        return (~work if holes else work), bool(len(small))

    def _postprocess_small_regions(self, records):
        """Fill small holes, then remove small islands, recompute the boxes,
        then NMS that prefers unchanged masks (score 1 against 0):
        segment_anything's postprocess_small_regions."""
        out, scores = [], []
        for r in records:
            m = r["segmentation"]
            m, ch_holes = self._remove_small(m, holes=True)
            m, ch_islands = self._remove_small(m, holes=False)
            if not m.any():
                continue
            r["segmentation"] = m
            r["bbox_xyxy"] = mask_to_box(m)
            out.append(r)
            scores.append(0.0 if ch_holes or ch_islands else 1.0)
        if not out:
            return out
        boxes = np.stack([r["bbox_xyxy"] for r in out])
        keep = box_nms(boxes, np.asarray(scores), self.box_nms_thresh)
        return [out[i] for i in sorted(keep)]
