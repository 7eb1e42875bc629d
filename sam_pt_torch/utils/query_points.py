"""Query-point selection from binary masks (host-side numpy).

A copy of `sam_pt_tpu/utils/query_points.py`, so that the port runs
without the JAX package; tests/test_torch_ops.py checks that both give the
same points from the same seed. Mirrors the sampler suite of the reference
(sam_pt/utils/query_points.py): random mask points (:29), K-Medoids (:62,
the default positive sampler), Shi-Tomasi corners on a proportionally
eroded mask (:102), and the mixed n/4-kmedoids + n/3-shi-tomasi +
rest-random blend (:197, the default negative sampler).

Implementation notes:
  - K-Medoids is a native deterministic-given-seed implementation (the
    reference depends on sklearn_extra; SURVEY.md §2.9 lists it as a package
    to replace). We use k-means++-style seeding on the subsample followed by
    alternating assign/update (PAM 'alternate'), which reproduces the
    reference's behavior class: spread medoids lying ON the mask.
  - Shi-Tomasi uses cv2.goodFeaturesToTrack with the reference's parameters
    (quality 0.001, min distance mask_diameter / n, block/gradient size 3).
  - These run on host per video (query-time only, not per-frame).

All functions take/return numpy; masks are [H, W] float {0,1}; points are
(x, y) float32.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in the target image
    cv2 = None


def _mask_pixels_yx(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    return np.stack([ys, xs], axis=1).astype(np.float32)


def _repeat_to(points: np.ndarray, n: int) -> np.ndarray:
    reps = int(np.ceil(n / len(points)))
    return np.tile(points, (reps, 1))[:n]


def extract_random_mask_points(
    mask: np.ndarray, n_points_to_select: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Uniformly sample mask pixels; repeat-pad when the mask is tiny."""
    rng = rng or np.random.default_rng()
    if mask.sum() == 0:
        print("Warning: empty mask in extract_random_mask_points")
        return np.zeros((n_points_to_select, 2), np.float32)
    pix = _mask_pixels_yx(mask)
    if len(pix) < n_points_to_select:
        sel = _repeat_to(pix, n_points_to_select)
    else:
        sel = pix[rng.permutation(len(pix))[:n_points_to_select]]
    return sel[:, ::-1].copy()  # (y, x) -> (x, y)


def kmedoids(
    points: np.ndarray, k: int, rng: np.random.Generator, max_iter: int = 100
) -> np.ndarray:
    """Deterministic-given-rng K-Medoids ('alternate' method, k-means++ seeding).

    points: [P, D]. Returns [k, D] medoids (actual input points).
    """
    p = len(points)
    # --- k-means++ style seeding on actual points
    first = int(rng.integers(p))
    medoid_idx = [first]
    d2 = ((points - points[first]) ** 2).sum(-1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        nxt = int(rng.choice(p, p=probs))
        medoid_idx.append(nxt)
        d2 = np.minimum(d2, ((points - points[nxt]) ** 2).sum(-1))
    medoid_idx = np.array(medoid_idx)

    # --- alternate: assign to nearest medoid, re-pick medoid per cluster
    for _ in range(max_iter):
        dists = ((points[:, None, :] - points[medoid_idx][None, :, :]) ** 2).sum(-1)
        assign = dists.argmin(1)
        new_idx = medoid_idx.copy()
        for c in range(k):
            members = np.nonzero(assign == c)[0]
            if len(members) == 0:
                continue
            sub = points[members]
            intra = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1).sum(1)
            new_idx[c] = members[intra.argmin()]
        if (new_idx == medoid_idx).all():
            break
        medoid_idx = new_idx
    return points[medoid_idx]


def extract_kmedoid_points(
    mask: np.ndarray,
    n_points_to_select: int,
    subsample_size: int = 1800,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """K-Medoids over (a subsample of) mask pixels — default positive sampler."""
    rng = rng or np.random.default_rng()
    if mask.sum() == 0:
        print("Warning: empty mask in extract_kmedoid_points")
        return np.zeros((n_points_to_select, 2), np.float32)
    pix = _mask_pixels_yx(mask)
    if len(pix) < n_points_to_select:
        sel = _repeat_to(pix, n_points_to_select)
    else:
        sub = pix[rng.permutation(len(pix))[:subsample_size]]
        sel = kmedoids(sub, n_points_to_select, rng)
    return sel[:, ::-1].astype(np.float32).copy()


def erode_mask_proportional_to_its_furthest_points_distance(
    mask: np.ndarray, erosion_percentage: float
) -> np.ndarray:
    """Erode by a square kernel sized as a fraction of the mask 'diameter'
    (bbox diagonal of mask pixels — reference query_points.py:165-194)."""
    pix = _mask_pixels_yx(mask)
    diameter = float(np.linalg.norm(pix.max(0) - pix.min(0)))
    size = int(diameter * erosion_percentage)
    if size < 1 or cv2 is None:
        return mask
    kernel = np.ones((size, size), np.uint8)
    return cv2.erode(mask.astype(np.uint8), kernel, iterations=1).astype(mask.dtype)


def extract_corner_points(
    image: np.ndarray,
    mask: np.ndarray,
    n_points_to_select: int,
    kmedoid_subsample_size: int = 2000,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Shi-Tomasi corners inside the (eroded) mask; K-Medoids fills shortfall.

    image: [H, W, 3] uint8 RGB.
    """
    rng = rng or np.random.default_rng()
    if mask.sum() == 0:
        print("Warning: empty mask in extract_corner_points")
        return np.zeros((n_points_to_select, 2), np.float32)

    eroded = mask
    for pct in (0.06, 0.02, 0.01):
        eroded = erode_mask_proportional_to_its_furthest_points_distance(mask, pct)
        if eroded.sum() >= 10:
            break
    if eroded.sum() < 10:
        eroded = mask

    pix = _mask_pixels_yx(eroded)
    diameter = float(np.linalg.norm(pix.max(0) - pix.min(0)))

    corners = None
    if cv2 is not None:
        gray = cv2.cvtColor(np.ascontiguousarray(image), cv2.COLOR_RGB2GRAY)
        corners = cv2.goodFeaturesToTrack(
            image=gray,
            maxCorners=n_points_to_select,
            qualityLevel=0.001,
            minDistance=diameter / n_points_to_select,
            mask=eroded.astype(np.uint8),
            blockSize=3,
            gradientSize=3,
        )
    pts = (
        np.empty((0, 2), np.float32)
        if corners is None
        else corners.reshape(-1, 2).astype(np.float32)
    )
    if len(pts) < n_points_to_select:
        fill = extract_kmedoid_points(
            mask, n_points_to_select - len(pts), kmedoid_subsample_size, rng
        )
        pts = np.concatenate([pts, fill], axis=0)
    return pts[:n_points_to_select]


def extract_mixed_points(
    query_masks: List[np.ndarray],
    query_points_timestep: np.ndarray,
    images: np.ndarray,
    n_points: int,
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """n/4 kmedoids + n/3 shi-tomasi + rest random — default negative sampler.

    images: [T, H, W, 3] uint8.
    """
    rng = rng or np.random.default_rng()
    n_kmedoid, n_shi = n_points // 4, n_points // 3
    n_random = n_points - n_kmedoid - n_shi
    parts: List[List[np.ndarray]] = []
    if n_kmedoid > 0:
        parts.append([extract_kmedoid_points(m, n_kmedoid, rng=rng) for m in query_masks])
    if n_shi > 0:
        parts.append(
            [
                extract_corner_points(
                    images[int(t)], m, n_shi, rng=rng
                )
                for m, t in zip(query_masks, query_points_timestep)
            ]
        )
    if n_random > 0:
        parts.append([extract_random_mask_points(m, n_random, rng=rng) for m in query_masks])
    if len(parts) == 1:
        return parts[0]
    return [np.concatenate(group, axis=0) for group in zip(*parts)]
