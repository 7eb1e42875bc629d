"""Patch-matching filtering in the port (`SamPt(use_patch_matching_
filtering=True)`, `sam_pt_torch/models/sam_pt.py`) against the JAX
package's, float32 on the CPU.

- `patch_similarities` (one pass over every (frame, point) pair) against
  JAX `_patch_similarities_jit` (BGR quirk included) to 1e-5 absolute.
- The whole forward on the tiny SamPt pair over a smooth moving pattern
  (`torch_port_helpers.smooth_video`): the visibility flags equal, every
  kind of flag present (visible, patch not similar, rejected after it,
  invisible), no similarity within their 1e-5 of the threshold;
  trajectories
  to 1e-3 px, scores to 1e-4 and masks as in test_torch_sam_pt.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.sam_pt import patch_similarities
from sam_pt_tpu.models.sam_pt import _patch_similarities_jit
from torch_port_helpers import smooth_video, tiny_sam_pt_pair

torch.set_num_threads(1)

LOGIT_ATOL = 2e-2
THRESHOLD = 0.01


def _video():
    masks = np.zeros((2, 48, 64), np.float32)
    masks[0, 10:25, 8:30] = 1
    masks[1, 28:45, 35:60] = 1
    return {"image": smooth_video(9), "target_hw": (48, 64),
            "query_masks": masks,
            "query_point_timestep": np.array([0, 3], np.float32)}


def test_patch_similarities_match_jax():
    rng = np.random.default_rng(2)
    images = smooth_video(5)
    traj = rng.uniform(-2, 66, (5, 7, 2)).astype(np.float32)
    qp = np.concatenate([rng.integers(0, 5, (7, 1)),
                         rng.uniform(0, 60, (7, 2))], 1).astype(np.float32)
    for patch_size in (3, 4):
        got = patch_similarities(torch.from_numpy(images),
                                 torch.from_numpy(traj),
                                 torch.from_numpy(qp), patch_size).numpy()
        ref = np.asarray(_patch_similarities_jit(
            jnp.asarray(images), jnp.asarray(traj), jnp.asarray(qp),
            patch_size))
        assert got.shape == (5, 7)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        # each point's patch on its own query frame, at its query position
        rows = qp[:, 0].astype(int)
        at_query = np.abs(traj[rows, np.arange(7)] - qp[:, 1:]).max(-1) == 0
        assert np.all(got[rows, np.arange(7)][at_query] == 1.0)


@pytest.fixture(scope="module")
def outputs():
    jsampt, tsampt = tiny_sam_pt_pair(use_patch_matching_filtering=True,
                                      patch_similarity_threshold=THRESHOLD)
    video = _video()
    sims = []
    original = tsampt._patch_filter

    def recorded(images, qp, traj, vis):
        sims.append(patch_similarities(
            images, traj.reshape(traj.shape[0], -1, 2),
            torch.from_numpy(qp.reshape(-1, 3)), tsampt.patch_size))
        return original(images, qp, traj, vis)

    tsampt._patch_filter = recorded
    jout = jsampt.forward(dict(video))
    tout = tsampt.forward(dict(video))
    return jout, tout, sims[0].numpy()


def test_visibility_flags_match_jax(outputs):
    jout, tout, sims = outputs
    got = tout["visibilities"].numpy()
    ref = np.asarray(jout["visibilities"])
    assert got.shape == (9, 2, 5)
    np.testing.assert_array_equal(got, ref)
    assert {1.0, 0.0, -3.0, -4.0} <= set(np.unique(ref).tolist())
    # no decision within the similarities' tolerance of the threshold
    assert np.abs(sims - THRESHOLD).min() > 1e-5


def test_trajectories_scores_and_masks_match_jax(outputs):
    jout, tout, _ = outputs
    np.testing.assert_allclose(tout["trajectories"].numpy(),
                               np.asarray(jout["trajectories"]), atol=1e-3,
                               rtol=0)
    for key in ("scores_per_frame", "scores"):
        np.testing.assert_allclose(tout[key].numpy(),
                                   np.asarray(jout[key], np.float32),
                                   atol=1e-4, rtol=0)
    got = tout["logits"].float().numpy()
    ref = np.stack(jout["logits"]).astype(np.float32)
    assert got.shape == ref.shape == (2, 9, 48, 64)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert finite.any() and not finite.all()
    np.testing.assert_allclose(got[finite], ref[finite], atol=LOGIT_ATOL,
                               rtol=1e-3)
    differ = (got > 0) != (ref > 0)
    assert np.all(np.abs(ref[differ]) < LOGIT_ATOL)
