"""The port's `SamPtInteractive` (`sam_pt_torch/models/sam_pt_interactive.
py`) against the JAX package's, end to end, float32 on the CPU: the tiny
SamPt pair (`torch_port_helpers.tiny_interactive_pair`: tiny SAM, tiny
CoTracker) over a 6-frame smooth moving pattern with a ground-truth box
moving down and right, in online and `disable_point_tracking` modes
(offline in test_torch_sam_pt_interactive_offline.py, a file of its own
so that test workers share the JAX compilations' time), each side's rng
reset to the same seed.

The interaction history's decisions must be identical (action, type,
frame, point, interactions left, threshold) and every IoU and boundary
score within 1e-4, on inputs where no IoU the loop records lies within
1e-3 of its threshold: the test asserts that premise, and the frames'
noise seed (18) is one that meets it in all three modes (with seed 16 an
offline IoU lies 2.8e-4 from 0.1; the decisions agree there too). Final IoUs to 1e-4,
trajectories to 1e-3 px, visibilities equal, logits as in
test_torch_sam_pt.py (the port's are float16), the history files written
with the same entries.
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import smooth_video, tiny_interactive_pair

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2
SCORES = ("iou_before", "iou_after", "overall_iou_before",
          "overall_iou_after", "boundary_score_before",
          "boundary_score_after", "overall_boundary_score_before",
          "overall_boundary_score_after", "jf_score_before",
          "jf_score_after")
DECISIONS = ("action", "type", "frame_idx", "point_idx", "interaction_idx",
             "current_iou_threshold")


def _video(t=6, h=48, w=64):
    gt = np.zeros((t, 1, h, w), np.float32)
    for i in range(t):
        gt[i, 0, 10 + i:25 + i, 8 + 2 * i:30 + 2 * i] = 1
    return {"image": smooth_video(t, h, w, seed=18), "target_hw": (h, w),
            "query_masks": gt[0], "query_point_timestep": np.zeros(1),
            "gt_masks": list(gt), "video_id": "v"}


@pytest.fixture(scope="module")
def pair():
    return tiny_interactive_pair(interactions_max=40,
                                 interactions_max_per_frame=2,
                                 online_interactive_iou_threshold=0.8)


@pytest.mark.parametrize("mode", ["online", "no_tracking"])
def test_interactive_matches_jax(pair, tmp_path, mode):
    compare_with_jax(pair, tmp_path, mode)


def compare_with_jax(pair, tmp_path, mode):
    """One forward of each side in `mode`, and every check above."""
    jmodel, tmodel = pair
    outs = {}
    for name, model in (("jax", jmodel), ("port", tmodel)):
        model.online = mode == "online"
        model.disable_point_tracking = mode == "no_tracking"
        model.output_root = str(tmp_path / name)
        model.rng = np.random.default_rng(72)
        outs[name] = model.forward(_video())
    jout, tout = outs["jax"], outs["port"]

    jh, th = jout["interaction_history"], tout["interaction_history"]
    assert len(jh) == len(th) > 3
    assert [[e[k] for k in DECISIONS] for e in th] == [
        [e[k] for k in DECISIONS] for e in jh]
    for je, te in zip(jh, th):
        for key in SCORES:
            assert te[key] == pytest.approx(je[key], abs=1e-4), key
        for key in ("iou_before", "iou_after"):
            assert abs(je[key] - je["current_iou_threshold"]) > 1e-3
    assert {e["action"] for e in jh} == {"add", "remove"} or (
        mode == "no_tracking")
    np.testing.assert_allclose(tout["final_ious"], jout["final_ious"],
                               atol=1e-4, rtol=0)

    np.testing.assert_allclose(tout["trajectories"].numpy(),
                               np.asarray(jout["trajectories"]), atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tout["visibilities"].numpy(),
                                  np.asarray(jout["visibilities"]))
    got = tout["logits"].float().numpy()
    ref = np.stack(jout["logits"]).astype(np.float32)
    assert got.shape == ref.shape == (1, 6, 48, 64)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=1e-3)
    differ = (got > 0) != (ref > 0)
    assert np.all(np.abs(ref[differ]) < LOGIT_ATOL)
    np.testing.assert_allclose(tout["scores"].numpy(), jout["scores"],
                               atol=1e-4, rtol=0)

    for name in ("jax", "port"):
        files = set(os.listdir(tmp_path / name / "v"))
        assert {"history.json", "achieved_iou_thresholds_cache.pkl",
                "final.pkl"} <= files
    with open(tmp_path / "port" / "v" / "history.json") as f:
        assert [[e[k] for k in DECISIONS] for e in json.load(f)] == [
            [e[k] for k in DECISIONS] for e in jh]
