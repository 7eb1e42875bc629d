"""Port `SamPt` with the SuperGlue tracker against the JAX `SamPt`, on the
tiny SAM and `torch_port_helpers.tiny_superglue_pair` (the matcher at its
published widths, K = 96, 20 Sinkhorn iterations), float32, the same seeds
on both sides, over a textured 48 x 64 video whose content moves.

SuperGlue keeps per-video mask state: both sides must hand it the same
query masks before each track (`set_masks`: the given masks, the masks SAM
decodes from query points, and with re-initialisation each window's), and
the outputs must then agree at test_torch_sam_pt_reinit.py's tolerances
(trajectories 1e-3 px, equal visibilities, IoU scores 1e-4, logits 2e-2).
A mask batch smaller than the video's masks is refused on both sides.
"""
import numpy as np
import pytest
import torch

from test_torch_sam_pt_reinit import REINIT, _assert_outputs_match
from torch_port_helpers import textured_video, tiny_sam_pt_pair

torch.set_num_threads(1)

# TINY_SAM_PT_SETTINGS' values of the keys REINIT sets
REINIT_OFF = dict(use_point_reinit=False, reinit_point_tracker_horizon=24,
                  reinit_horizon=24, iterative_refinement_iterations=3)


def _video(t, query_ts=(0, 0)):
    masks = np.zeros((2, 48, 64), np.float32)
    masks[0, 8:30, 6:34] = 1
    masks[1, 24:46, 30:62] = 1
    return {"image": textured_video(t, 48, 64, seed=7), "target_hw": (48, 64),
            "query_masks": masks,
            "query_point_timestep": np.asarray(query_ts, np.float32)}


def _record_masks(sampt):
    """Wrap the tracker's `set_masks` to record every mask set."""
    calls = []
    tracker = sampt.point_tracker
    set_masks = tracker.set_masks

    def wrapped(masks):
        calls.append(np.array(masks))
        set_masks(masks)

    tracker.set_masks = wrapped
    return calls


@pytest.fixture(scope="module")
def pair():
    """One (JAX, port) pair for the file: the JAX side compiles once."""
    jsampt, tsampt = tiny_sam_pt_pair(tracker="superglue")
    return jsampt, tsampt, _record_masks(jsampt), _record_masks(tsampt)


def _run(pair, video, **settings):
    """Both SamPts with `settings` and fresh rngs over `video`: the masks
    each set and the outputs agree. Returns the port's outputs and
    masks."""
    jsampt, tsampt, jmasks, tmasks = pair
    for sampt in (jsampt, tsampt):
        for k, v in dict(REINIT_OFF, **settings).items():
            setattr(sampt, k, v)
        sampt.rng = np.random.default_rng(72)
        sampt.point_tracker.rng = np.random.default_rng(72)
    del jmasks[:], tmasks[:]
    jout = jsampt.forward(dict(video))
    tout = tsampt.forward(video)
    assert len(jmasks) == len(tmasks) >= 1
    for jm, tm in zip(jmasks, tmasks):
        np.testing.assert_array_equal(tm, jm)
    assert tsampt.point_tracker.masks is None  # consumed
    jout = dict(jout, logits=list(np.asarray(jout["logits"])))
    _assert_outputs_match(jout, tout)
    return tout, list(tmasks)


def test_query_masks(pair):
    tout, masks = _run(pair, _video(3))
    assert len(masks) == 1 and masks[0].shape == (2, 48, 64)
    vis = tout["visibilities"].numpy()
    assert (vis[1:, :, :4] == 1).any()  # matched positives reach SAM


def test_query_points(pair):
    """Query points on frame 0: the masks SAM decodes from them go to the
    tracker (the port used to drop them)."""
    rng = np.random.default_rng(0)  # points whose masks are not empty
    video = _video(3)
    centres = ([20, 19], [46, 35])
    points = np.stack([np.concatenate([np.zeros((5, 1)), rng.uniform(
        np.subtract(c, 6), np.add(c, 6), (5, 2))], 1) for c in centres])
    del video["query_masks"], video["query_point_timestep"]
    video["query_points"] = points.astype(np.float32)
    tout, masks = _run(pair, video)
    assert len(masks) == 1 and masks[0].shape == (2, 48, 64)
    assert masks[0].any(axis=(1, 2)).all()


def test_reinit(pair):
    """Re-initialisation over 5 frames, query frames 0 and 2: every
    window's masks, decoded from its query points, go to the tracker."""
    tout, masks = _run(pair, _video(5, (0, 2)), **REINIT)
    assert len(masks) > 3  # the forward's, then one set a window
    assert tout["trajectories"].shape == (5, 2, 5, 2)


def test_mask_batch_must_cover_every_mask(pair):
    jsampt, tsampt, *_ = pair
    video = _video(3)
    for sampt in (jsampt, tsampt):
        sampt.point_tracker_mask_batch_size = 1
    try:
        with pytest.raises(AssertionError):
            jsampt.forward(dict(video))
        with pytest.raises(ValueError, match="point_tracker_mask_batch_size"):
            tsampt.forward(video)
    finally:
        for sampt in (jsampt, tsampt):
            sampt.point_tracker_mask_batch_size = 5
