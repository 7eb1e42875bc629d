"""The whole slice: port `SamPt` against JAX `SamPt` on a tiny config with
the same weights, in float32.

Tiny SAM (`vit_tiny_test`, 64-pixel input) and the tiny CoTracker of
tests/test_cotracker.py (one refinement iteration per window, see
test_torch_cotracker.py), query masks of two objects on frames 0 and 3,
k-medoids positives + a mixed negative + other objects' positives as
negatives, the two-pass chain and 3 box-refinement passes, logits resized
to a 2x target, then device fusion to index masks.

Tolerances: trajectories 1e-3 px and IoU scores 1e-4 (float32 summation
order); logits are float16 at the output, so 2e-2 absolute on values of
order 10, and binary masks / fused labels may differ only at pixels whose
logits lie within that tolerance of the decision boundary.
"""
import numpy as np
import pytest
import torch

from sam_pt_torch.vos_eval.eval import device_fuse_index_masks as t_fuse
from sam_pt_tpu.vos_eval.eval import device_fuse_index_masks as j_fuse
from torch_port_helpers import tiny_sam_pt_pair

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2


def _video():
    rng = np.random.default_rng(16)
    t, h, w = 9, 48, 64
    masks = np.zeros((2, h, w), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    return {
        "image": rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8),
        "target_hw": (96, 128),
        "query_masks": masks,
        "query_point_timestep": np.array([0, 3], np.float32),
    }


@pytest.fixture(scope="module")
def outputs():
    jsampt, tsampt = tiny_sam_pt_pair()
    video = _video()
    jout = jsampt.forward(dict(video, keep_logits_on_device=True))
    tout = tsampt.forward(video)
    return video, jout, tout


def test_trajectories_and_visibilities(outputs):
    _, jout, tout = outputs
    assert tout["trajectories"].shape == (9, 2, 5, 2)
    np.testing.assert_allclose(tout["trajectories"].numpy(),
                               np.asarray(jout["trajectories"]), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tout["visibilities"].numpy(),
                                  np.asarray(jout["visibilities"]))


def test_scores(outputs):
    _, jout, tout = outputs
    for key in ("scores_per_frame", "scores"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=0)


def test_logits_and_masks(outputs):
    _, jout, tout = outputs
    got = tout["logits"].float().numpy()
    ref = np.asarray(jout["logits"], np.float32)
    assert got.shape == ref.shape == (2, 9, 96, 128)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert finite.any() and not finite.all()  # gating did both
    np.testing.assert_allclose(got[finite], ref[finite], atol=LOGIT_ATOL,
                               rtol=1e-3)
    differ = (got > 0) != (ref > 0)
    assert np.all(np.abs(ref[differ]) < LOGIT_ATOL)


def test_fused_index_masks(outputs):
    video, jout, tout = outputs
    ts = [0, 3]
    gt = video["query_masks"].repeat(2, axis=1).repeat(2, axis=2)  # 2x
    got = t_fuse(tout["logits"], gt, ts)
    ref = j_fuse(jout["logits"], gt, ts)
    assert got.shape == ref.shape == (9, 96, 128) and got.dtype == np.uint8
    assert np.array_equal(t_fuse(tout["logits"], gt, ts, defer=True).get(),
                          got)
    # fusion compares per-object logits against a zero background
    near = (np.abs(np.asarray(jout["logits"], np.float32)) < LOGIT_ATOL).any(0)
    assert np.array_equal(got[~near], ref[~near])
