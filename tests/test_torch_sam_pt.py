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
import jax
import numpy as np
import pytest
import torch

import sam_pt_tpu.utils.testing as jtesting
from sam_pt_torch.models.sam.predictor import SamPredictor as TPredictor
from sam_pt_torch.models.sam.sam_model import Sam as TSam
from sam_pt_torch.models.sam_pt import SamPt as TSamPt
from sam_pt_torch.models.tracker.cotracker.model import CoTracker as TCoTracker
from sam_pt_torch.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker as TTracker,
)
from sam_pt_torch.utils.checkpoint import (
    cotracker_state_dict_from_jax,
    sam_state_dict_from_jax,
)
from sam_pt_torch.vos_eval.eval import device_fuse_index_masks as t_fuse
from sam_pt_tpu.models.sam.predictor import SamPredictor as JPredictor
from sam_pt_tpu.models.sam.sam_model import Sam as JSam
from sam_pt_tpu.models.sam_pt import SamPt as JSamPt
from sam_pt_tpu.models.tracker.cotracker.model import CoTracker as JCoTracker
from sam_pt_tpu.models.tracker.cotracker.tracker import (
    CoTrackerPointTracker as JTracker,
)
from sam_pt_tpu.utils.checkpoint import (
    convert_cotracker_state_dict,
    convert_sam_state_dict,
)
from sam_pt_tpu.vos_eval.eval import device_fuse_index_masks as j_fuse
from torch_port_helpers import (
    TINY_COTRACKER,
    random_cotracker_state_dict,
    random_sam_state_dict,
)

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2
SETTINGS = dict(
    sam_iou_threshold=0.0,
    positive_point_selection_method="kmedoids",
    negative_point_selection_method="mixed",
    positive_points_per_mask=4,
    negative_points_per_mask=1,
    add_other_objects_positive_points_as_negative_points=True,
    iterative_refinement_iterations=3,
    sam_decode_chunk=8,
    sam_encode_chunk=4,
)
TRACKER = dict(interp_shape=(32, 40), visibility_threshold=0.5,
               support_grid_size=2, support_grid_every_n_frames=6, iters=1)


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
    sam_params = convert_sam_state_dict(random_sam_state_dict(seed=17))
    cot_sd = random_cotracker_state_dict(seed=18, flow_head_scale=0.05,
                                         **TINY_COTRACKER)
    cot_sd["vis_predictor.0.bias"][:] = 2.0  # most points visible
    cot_params = convert_cotracker_state_dict(cot_sd)

    jtracker = JTracker(params=cot_params, s=4, stride=4, **TRACKER)
    jtracker.model = JCoTracker(**TINY_COTRACKER)
    jpredictor = JPredictor(
        JSam(encoder_variant="vit_tiny_test", image_size=64), sam_params)
    jsampt = JSamPt(jtracker, jpredictor, **SETTINGS)
    video = _video()
    jout = jsampt.forward(dict(video, keep_logits_on_device=True))

    tsam = TSam(jtesting.TINY_VIT, image_size=64)
    tsam.load_state_dict(sam_state_dict_from_jax(sam_params))
    tcot = TCoTracker(**TINY_COTRACKER)
    tcot.load_state_dict(cotracker_state_dict_from_jax(cot_params))
    tsampt = TSamPt(TTracker(tcot.eval().requires_grad_(False), **TRACKER),
                    TPredictor(tsam.eval().requires_grad_(False)), **SETTINGS)
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
