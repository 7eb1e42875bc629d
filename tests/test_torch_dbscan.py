"""The port's DBSCAN (`sam_pt_torch/utils/dbscan.py`, scipy's k-d tree)
against scikit-learn's `DBSCAN`, and `extract_largest_cluster_points`
against the JAX package's (which calls scikit-learn) with the same rng.

The labels must be equal, not only equal up to relabelling: clusters are
numbered in the order of their lowest core point and a border point
within reach of several clusters joins the lowest-numbered one, as
scikit-learn's expansion (clusters grown one at a time from the
unlabelled core points in index order) assigns it. Points are pixel
coordinates, so squared distances are exact integers and "within eps"
has one answer on both sides (eps^2 is never an integer here).
"""
import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from sam_pt_torch.models import sam_pt_interactive as t_interactive
from sam_pt_torch.utils.dbscan import dbscan
from sam_pt_tpu.models import sam_pt_interactive as j_interactive


def _blobs(seed):
    """Pixel-coordinate blobs of varied density, some touching, plus
    scattered noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 120, (rng.integers(1, 6), 2))
    pts = [c + rng.normal(0, rng.uniform(2, 12), (rng.integers(20, 400), 2))
           for c in centers]
    pts.append(rng.uniform(0, 140, (rng.integers(0, 60), 2)))
    return np.round(np.concatenate(pts)).astype(np.float32)


@pytest.mark.parametrize("seed", range(12))
def test_labels_and_core_points_match_sklearn(seed):
    pts = _blobs(seed)
    eps = float(np.random.default_rng(100 + seed).uniform(1.5, 6.5))
    ref = DBSCAN(eps=eps, min_samples=10).fit(pts)
    labels, core = dbscan(pts, eps, min_samples=10)
    np.testing.assert_array_equal(labels, ref.labels_)
    ref_core = np.zeros(len(pts), bool)
    ref_core[ref.core_sample_indices_] = True
    np.testing.assert_array_equal(core, ref_core)


def test_border_point_joins_the_first_grown_cluster():
    """Two dense blocks 4 px apart on either side of one point within eps
    of a core point of each: scikit-learn gives it to the cluster whose
    lowest core index comes first, whichever block that is."""
    left = np.array([[x, y] for x in (-2, -1, 0) for y in range(12)],
                    np.float32)
    right = np.array([[x, y] for x in (4, 5, 6) for y in range(12)],
                     np.float32)
    bridge = np.array([[2, 5.0]], np.float32)
    for pts in (np.concatenate([left, right, bridge]),
                np.concatenate([bridge, right, left])):
        ref = DBSCAN(eps=2.0, min_samples=10).fit(pts)
        labels, _ = dbscan(pts, 2.0, min_samples=10)
        np.testing.assert_array_equal(labels, ref.labels_)
        assert set(labels.tolist()) == {0, 1}
        # the block listed first is grown first, and claims the bridge
        assert labels[np.all(pts == bridge, axis=1)][0] == 0


def test_no_core_point_is_all_noise():
    pts = np.array([[0, 0], [10, 10], [20, 20]], np.float32)
    labels, core = dbscan(pts, 3.0, min_samples=10)
    assert (labels == -1).all() and not core.any()
    assert dbscan(np.zeros((0, 2)), 3.0, 10)[0].shape == (0,)


def test_full_size_mask_matches_sklearn():
    """18000 pixels of two boxes in a 480 x 854 frame at the interactive
    loop's eps (2.4 * H * W / 18000 = 54.65)."""
    mask = np.zeros((480, 854), bool)
    mask[60:200, 80:300] = True
    mask[300:420, 500:700] = True
    pix = np.stack(np.nonzero(mask), -1).astype(np.float32)
    sub = pix[np.random.default_rng(0).permutation(len(pix))[:18000]]
    eps = 2.4 * 480 * 854 / 18000
    ref = DBSCAN(eps=eps, min_samples=10).fit(sub)
    labels, _ = dbscan(sub, eps, min_samples=10)
    np.testing.assert_array_equal(labels, ref.labels_)


@pytest.mark.parametrize("case", ["two_blobs", "small", "thin", "one_pixel"])
def test_extract_largest_cluster_points_matches_jax(case):
    mask = np.zeros((60, 80), bool)
    if case == "two_blobs":
        mask[5:30, 5:40] = True
        mask[40:55, 50:75] = True
    elif case == "small":
        mask[10:14, 10:13] = True  # below the 180-pixel cluster minimum
    elif case == "thin":
        mask[20, 3:70] = True
        mask[30:50, 60:62] = True
    else:
        mask[7, 9] = True
    n = min(3, int(mask.sum()))
    for seed in range(3):
        got = t_interactive.extract_largest_cluster_points(
            mask, n, rng=np.random.default_rng(seed))
        ref = j_interactive.extract_largest_cluster_points(
            mask, n, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, ref)
        assert mask[got[:, 1].astype(int), got[:, 0].astype(int)].all()
