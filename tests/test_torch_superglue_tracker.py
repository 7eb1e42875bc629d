"""The SuperGlue point tracker in the port (`sam_pt_torch/models/tracker/
superglue/tracker.py`) against the JAX package's, on one random magicleap
checkpoint pair (`torch_port_helpers.superglue_pair`: the port reads the
.pth files as they are, the JAX tracker its converters' trees with the
heads in its layout), the matcher at its published widths, 20 Sinkhorn
iterations, K = 96 keypoints.

The port detects all frames in one batch and matches the T-1 pairs in one
batch; the JAX tracker one frame and one pair at a time. With the same
seed the host's quota sampling draws the same points, so trajectories and
visibilities must be equal (the keypoints are integer pixels); the test
asserts that every frame matched something, that the matches are equal
(their margins are test_torch_superglue.py's) and that the masks are
consumed. The JAX matcher runs under `jax.jit`, once for the video's
shape.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import superglue_pair, textured_video

torch.set_num_threads(1)

SETTINGS = dict(positive_points_per_mask=3, negative_points_per_mask=2,
                max_keypoints=96, sinkhorn_iterations=20, seed=5)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return superglue_pair(tmp_path_factory.mktemp("superglue"), weights_seed=3,
                          **SETTINGS)


def _masks(h, w):
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:60, 8:70] = 1
    masks[1, 40:90, 60:124] = 1
    return masks


def _query_points(n, h, w, seed=0):
    qp = np.zeros((1, n, 3), np.float32)
    qp[0, :, 1:] = np.random.default_rng(seed).uniform([4, 4], [w - 4, h - 4],
                                                       (n, 2))
    return qp


def test_tracker_matches_jax(pair):
    jtracker, tracker = pair
    t, h, w = 4, 96, 128
    video = textured_video(t, h, w, seed=2)[None]
    qp = _query_points(10, h, w)
    masks = _masks(h, w)

    with pytest.raises(AssertionError):  # the JAX tracker refuses too
        jtracker.forward(video, qp)
    with pytest.raises(ValueError, match="set_masks"):
        tracker.forward(torch.from_numpy(video), qp)

    jtracker.set_masks(masks)
    ref_traj, ref_vis = jtracker.forward(video, qp)
    tracker.set_masks(masks)
    traj, vis = tracker.forward(torch.from_numpy(video), qp)
    assert tracker.masks is None and jtracker.masks is None  # consumed
    assert traj.shape == (1, t, 10, 2) and vis.shape == (1, t, 10)
    np.testing.assert_array_equal(traj, ref_traj)
    np.testing.assert_array_equal(vis, ref_vis)
    np.testing.assert_array_equal(traj[0, 0], qp[0, :, 1:])
    # every later frame has a visible point, and shortfalls are (-1, -1);
    # frame 0's query points are not marked visible, as in JAX
    assert (vis[0, 1:].sum(-1) > 0).all() and not vis[0, 0].any()
    assert (vis[0, 1:] == 0).any()
    np.testing.assert_array_equal(traj[0, 1:][vis[0, 1:] == 0], -1.0)

    # the same video again: the rngs moved on together
    jtracker.set_masks(masks)
    tracker.set_masks(masks)
    np.testing.assert_array_equal(
        tracker.forward(torch.from_numpy(video), qp)[0],
        jtracker.forward(video, qp)[0])


def test_matches_of_the_batched_pairs(pair):
    """The batched pairs against single pairs, and enough matches on the
    textured video that the sampling has something to draw from."""
    from sam_pt_torch.ops.color import rgb_to_gray

    _, tracker = pair
    video = torch.from_numpy(textured_video(4, 96, 128, seed=2))
    det = tracker.detect(rgb_to_gray(video) / 255.0)
    det0 = {k: v[:1] for k, v in det.items()}
    det1 = {k: v[1:] for k, v in det.items()}
    batched = tracker.match(det0, det1, (96, 128))
    for i in range(3):
        one = tracker.match(det0, {k: v[i:i + 1] for k, v in det1.items()},
                            (96, 128))
        np.testing.assert_array_equal(one[0].numpy(), batched[i].numpy())
    assert ((batched > -1).sum(1) >= 5).all()
