"""DBSCAN on 2-D points, with scikit-learn's labels, from scipy's k-d tree
(the port does not depend on scikit-learn).

scikit-learn's `DBSCAN(eps, min_samples).fit(points)` marks a point core
when at least `min_samples` points (itself included) lie within `eps`,
then grows clusters depth-first from the unlabelled core points in index
order. So:
  - a cluster is a connected component of the core points (two core points
    joined when within `eps`), and the clusters are numbered in the order
    of their lowest core index;
  - a non-core point within `eps` of core points of several clusters joins
    the lowest-numbered one (that cluster is grown, and claims it, first);
    one with no core point in reach is noise (-1).
This module computes the same labels without listing every neighbourhood:
core points in one cell of side eps / sqrt(2) are all within `eps` of each
other, so cells are joined whole, and two cells are joined when their
closest pair of core points is within `eps`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


def _components(points: np.ndarray, eps: float) -> np.ndarray:
    """Connected components of `points` [N, 2] under "within eps", each
    labelled by the lowest index in it."""
    n = len(points)
    parent = np.arange(n)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i: int, j: int) -> None:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    side = eps / np.sqrt(2.0)
    cells = {}
    for i, key in enumerate(map(tuple, np.floor(points / side).astype(
            np.int64))):
        cells.setdefault(key, []).append(i)
    members = {key: np.asarray(idx) for key, idx in cells.items()}
    for idx in members.values():
        for j in idx[1:]:
            union(idx[0], j)
    trees = {key: cKDTree(points[idx]) for key, idx in members.items()}
    # Cells up to two apart can hold points within eps (the nearest points
    # of cells three apart, or two apart on both axes, are farther).
    offsets = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
               if (dy, dx) > (0, 0) and not (abs(dy) == 2 and abs(dx) == 2)]
    for (cy, cx), idx in members.items():
        for dy, dx in offsets:
            other = (cy + dy, cx + dx)
            if other not in members or find(idx[0]) == find(
                    members[other][0]):
                continue
            dist, _ = trees[other].query(points[idx], k=1)
            if (dist <= eps).any():
                union(idx[0], members[other][0])
    return np.asarray([find(i) for i in range(n)])


def dbscan(points: np.ndarray, eps: float,
           min_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """points [N, 2] -> (labels [N] int64, -1 for noise; core [N] bool),
    the labels scikit-learn's `DBSCAN(eps=eps, min_samples=min_samples)`
    gives for the same points in the same order (Euclidean distance, a
    neighbour within `eps` inclusive)."""
    points = np.asarray(points, np.float64)
    labels = np.full(len(points), -1, np.int64)
    if len(points) == 0:
        return labels, np.zeros(0, bool)
    tree = cKDTree(points)
    counts = tree.query_ball_point(points, eps, return_length=True)
    core = counts >= min_samples
    core_idx = np.nonzero(core)[0]
    if len(core_idx) == 0:
        return labels, core
    roots = _components(points[core_idx], eps)  # lowest member, local index
    order = {root: k for k, root in enumerate(sorted(set(roots.tolist())))}
    labels[core_idx] = [order[r] for r in roots]
    # Non-core points have fewer than min_samples neighbours, so their
    # neighbourhoods are short lists.
    border = np.nonzero(~core)[0]
    for i, near in zip(border, tree.query_ball_point(points[border], eps)):
        reached = [labels[j] for j in near if core[j]]
        if reached:
            labels[i] = min(reached)
    return labels, core
