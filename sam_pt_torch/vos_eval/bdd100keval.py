"""BDD100K VOS evaluation: per-object J/F with visible/non-visible splits
(counterpart of `sam_pt_tpu/vos_eval/bdd100keval.py`, without pandas or
Pillow: tables are plain dicts of columns, PNGs go through the port's
codec).

Native re-implementation of the reference BDD100K scorer
(sam_pt/vos_eval/bdd100keval.py): unlike DAVIS, objects appear mid-video, so
per object only frames AFTER its first appearance are scored (the appearance
frame itself is excluded, :166-185); each metric is additionally split into
frames where the GT object is visible vs not; objects appearing only in the
last frame score 1.0 across the board (:173-177). Metric computation
parallelizes over objects with a process pool (:218-246). The reference's
SegGPT-specific result-format hooks are intentionally not carried over
(overlapping-mask .pt payloads were an external model's private format); PNG
index-mask results — what this framework writes — are fully supported.

Runnable as a CLI against saved PNG results, like the reference (:1-24).
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from os import path
from typing import Dict, List, Tuple, Union

import numpy as np

from .data.image_io import read_index_mask
from .davis2017eval import Table, format_table
from .metrics import db_eval_boundary, db_eval_iou, db_statistics


def _read_mask(file: str) -> np.ndarray:
    return read_index_mask(file)[0].astype(np.int32)


def _columns(rows: List[dict]) -> Table:
    """Row dicts as columns, in the order the keys first appear; a row
    without a column holds NaN there."""
    names: List[str] = []
    for row in rows:
        names.extend(k for k in row if k not in names)
    return {k: [row.get(k, np.nan) for row in rows] for k in names}


class BDD100KDataset:
    def __init__(self, root: str, sequences: Union[str, List[str]] = "all"):
        self.root = root
        self.img_path = path.join(root, "JPEGImages")
        self.mask_path = path.join(root, "Annotations")
        if sequences == "all":
            self.sequences = sorted(os.listdir(self.mask_path))
        else:
            self.sequences = list(sequences)

    def get_all_masks(self, seq: str) -> Tuple[np.ndarray, List[str]]:
        mask_dir = path.join(self.mask_path, seq)
        frames = sorted(f for f in os.listdir(mask_dir) if f.endswith(".png"))
        masks = np.stack([_read_mask(path.join(mask_dir, f))
                          for f in frames])
        ids = [f[:-4] for f in frames]
        return masks, ids


def _read_result_masks(res_dir: str, seq: str, mask_ids: List[str]) -> np.ndarray:
    seq_dir = path.join(res_dir, seq)
    available = sorted(os.listdir(seq_dir))
    out = []
    for mid in mask_ids:
        p = path.join(seq_dir, f"{mid}.png")
        if path.exists(p):
            out.append(_read_mask(p))
        elif available:
            # harnesses may not save frames before the first object appears
            out.append(np.zeros_like(
                _read_mask(path.join(seq_dir, available[0]))))
        else:
            raise FileNotFoundError(f"{seq}/{mid}.png not found in {res_dir}")
    masks = np.stack(out)
    if set(np.unique(masks).tolist()) == {0, 255}:
        masks = masks // 255
    return masks


def compute_metrics_for_object(args):
    """Per-object J/F with first-appearance and visibility handling.

    Returns None for object ids that never appear in the sequence (BDD
    annotations may have gaps in the id range from dropped/merged tracks)."""
    ii, masks_gt, masks_res = args
    gt_visibility = masks_gt.sum(axis=(1, 2)) > 0
    if not gt_visibility.any():
        return None
    appeared = int(np.nonzero(gt_visibility)[0][0])
    if appeared == len(masks_gt) - 1:
        one = np.array([1.0])
        return ii, 1, 1, one, one, one, one, one, one
    gt_visibility = gt_visibility[appeared + 1 :]
    masks_gt = masks_gt[appeared + 1 :]
    masks_res = masks_res[appeared + 1 :]

    n_frames = len(gt_visibility) + 1
    visible_frames = int(gt_visibility.sum()) + 1

    j = db_eval_iou(masks_gt, masks_res, None)
    f = db_eval_boundary(masks_gt, masks_res, None)
    return (
        ii, n_frames, visible_frames,
        j, f,
        j[gt_visibility], f[gt_visibility],
        j[~gt_visibility], f[~gt_visibility],
    )


class BDD100KEvaluator:
    def __init__(self, results_path: str, dataset_path: str,
                 sequences: Union[str, List[str]] = "all",
                 use_process_pool: bool = True):
        self.results_path = results_path
        self.dataset = BDD100KDataset(dataset_path, sequences)
        self.use_process_pool = use_process_pool

    def evaluate(self) -> Tuple[Table, Table]:
        agg = {
            k: {"M": [], "R": [], "D": []}
            for k in ("J", "J_vis", "J_nonvis", "F", "F_vis", "F_nonvis")
        }
        per_seq_rows = []

        for seq in self.dataset.sequences:
            gt, mask_ids = self.dataset.get_all_masks(seq)
            res = _read_result_masks(self.results_path, seq, mask_ids)
            max_gt_id = int(gt.max())
            assert max_gt_id > 0, f"No objects in GT for {seq}"

            tasks = [
                (ii - 1, gt == ii, res == ii) for ii in range(1, max_gt_id + 1)
            ]
            if self.use_process_pool and len(tasks) > 1:
                with ProcessPoolExecutor() as ex:
                    results = list(ex.map(compute_metrics_for_object, tasks))
            else:
                results = [compute_metrics_for_object(t) for t in tasks]

            results = [r for r in results if r is not None]  # absent ids
            for (ii, n_frames, vis_frames, j, f, j_v, f_v, j_nv, f_nv) in results:
                row = {"Sequence": f"{seq}_{ii + 1}", "n_frames": n_frames,
                       "visible_frames": vis_frames}
                for name, series in (
                    ("J", j), ("J_vis", j_v), ("J_nonvis", j_nv),
                    ("F", f), ("F_vis", f_v), ("F_nonvis", f_nv),
                ):
                    if len(series) == 0:
                        continue
                    m, r, d = db_statistics(np.asarray(series))
                    agg[name]["M"].append(m)
                    agg[name]["R"].append(r)
                    agg[name]["D"].append(d)
                    row[f"{name}-Mean"] = m
                per_seq_rows.append(row)

        g = {}
        jm = float(np.mean(agg["J"]["M"]))
        fm = float(np.mean(agg["F"]["M"]))
        g["J&F-Mean"] = [(jm + fm) / 2]
        for name in ("J", "J_vis", "J_nonvis", "F", "F_vis", "F_nonvis"):
            vals = agg[name]
            g[f"{name}-Mean"] = [float(np.mean(vals["M"])) if vals["M"] else np.nan]
            g[f"{name}-Recall"] = [float(np.mean(vals["R"])) if vals["R"] else np.nan]
            g[f"{name}-Decay"] = [float(np.mean(vals["D"])) if vals["D"] else np.nan]
        df_global = g
        df_per_seq = _columns(per_seq_rows)
        print(format_table(df_global))
        return df_global, df_per_seq


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Score saved VOS PNGs on BDD100K")
    ap.add_argument("--results_path", required=True)
    ap.add_argument("--dataset_path", required=True)
    args = ap.parse_args()
    BDD100KEvaluator(args.results_path, args.dataset_path).evaluate()


if __name__ == "__main__":
    main()
