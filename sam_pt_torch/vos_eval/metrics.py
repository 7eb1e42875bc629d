"""Native DAVIS J (region IoU) and F (boundary) metrics (a copy of
`sam_pt_tpu/vos_eval/metrics.py`; F's boundary matching reads a distance
transform over the boundaries' box instead of dilating whole frames,
which gives the same counts in less time).

Re-implements the `davis2017` evaluation package the reference wraps
(sam_pt/vos_eval/davis2017eval.py:24; SURVEY.md §2.9 lists it as a package to
replace): `db_eval_iou`, `db_eval_boundary` (bipartite boundary matching with
a diagonal-proportional tolerance), and `db_statistics` (mean / recall /
decay), following the published DAVIS 2017 evaluation semantics.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def db_eval_iou(
    annotation: np.ndarray,
    segmentation: np.ndarray,
    void_pixels: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Jaccard index per frame.

    annotation/segmentation: [..., H, W] binary; returns [...] float, with
    J = 1 for frames where both masks are empty (union == 0).
    """
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    if void_pixels is None:
        void = np.zeros_like(segmentation)
    else:
        void = void_pixels.astype(bool)

    inters = np.sum((segmentation & annotation) & ~void, axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void, axis=(-2, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        j = inters.astype(np.float64) / union
    if j.ndim == 0:
        return np.float64(1.0) if np.isclose(union, 0) else j
    j[np.isclose(union, 0)] = 1.0
    return j


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary segmentation -> boundary map (pixels adjacent to a change)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def _matched(bmap: np.ndarray, other: np.ndarray, radius: int) -> int:
    """How many set pixels of `bmap` lie within `radius` (Euclidean,
    inclusive) of a set pixel of `other`: those of `bmap` inside `other`
    dilated by the disk x^2 + y^2 <= radius^2, read from a distance
    transform over the box that holds both maps' pixels (the same pixels
    as `ndimage.binary_dilation` with the disk, in less time)."""
    if not bmap.any() or not other.any():
        return 0
    rows = np.nonzero((bmap | other).any(axis=1))[0]
    cols = np.nonzero((bmap | other).any(axis=0))[0]
    box = (slice(rows[0], rows[-1] + 1), slice(cols[0], cols[-1] + 1))
    near = ndimage.distance_transform_edt(~other[box]) <= max(radius, 0)
    return int((bmap[box] & near).sum())


def f_measure(
    foreground_mask: np.ndarray,
    gt_mask: np.ndarray,
    void_pixels: Optional[np.ndarray] = None,
    bound_th: float = 0.008,
) -> float:
    """DAVIS boundary F-measure for one frame.

    Boundary pixels of prediction and GT are matched within a tolerance of
    bound_th * image diagonal (as dilating the other boundary by a disk of
    that radius does); F = harmonic mean of boundary precision and recall.
    """
    if void_pixels is not None:
        v = void_pixels.astype(bool)
        foreground_mask = foreground_mask.astype(bool) & ~v
        gt_mask = gt_mask.astype(bool) & ~v

    fg_boundary = _seg2bmap(foreground_mask.astype(bool))
    gt_boundary = _seg2bmap(gt_mask.astype(bool))

    bound_pix = (
        bound_th
        if bound_th >= 1
        else int(np.ceil(bound_th * np.linalg.norm(foreground_mask.shape)))
    )
    n_fg_match = _matched(fg_boundary, gt_boundary, int(bound_pix))
    n_gt_match = _matched(gt_boundary, fg_boundary, int(bound_pix))

    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0
    if n_fg == 0 and n_gt == 0:
        return 1.0

    precision = n_fg_match / n_fg
    recall = n_gt_match / n_gt
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def db_eval_boundary(
    annotation: np.ndarray,
    segmentation: np.ndarray,
    void_pixels: Optional[np.ndarray] = None,
    bound_th: float = 0.008,
) -> np.ndarray:
    """Boundary F per frame; inputs [T, H, W] (or [H, W])."""
    if annotation.ndim == 2:
        return np.float64(
            f_measure(segmentation, annotation, void_pixels, bound_th)
        )
    t = annotation.shape[0]
    out = np.zeros(t)
    for i in range(t):
        v = None if void_pixels is None else void_pixels[i]
        out[i] = f_measure(segmentation[i], annotation[i], v, bound_th)
    return out


def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """(mean M, recall O, decay D) of a per-frame metric series (DAVIS defs)."""
    with np.errstate(invalid="ignore"):
        m = np.nanmean(per_frame_values)
        o = np.nanmean(per_frame_values > 0.5)

    n_bins = 4
    ids = (
        np.round(np.linspace(1, len(per_frame_values), n_bins + 1) + 1e-10) - 1
    ).astype(int)
    d_bins = [per_frame_values[ids[i] : ids[i + 1] + 1] for i in range(n_bins)]
    with np.errstate(invalid="ignore"):
        d = np.nanmean(d_bins[0]) - np.nanmean(d_bins[3])
    return float(m), float(o), float(d)
