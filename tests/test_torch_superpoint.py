"""SuperPoint in the port (`sam_pt_torch/models/tracker/superglue/
superpoint.py`) against the JAX package's, in float32, on one random
`superpoint_v1.pth`-namespace state dict (`torch_port_helpers`), which
the port loads as it is and the JAX side through its converter.

The port runs the frames as one batch; each frame must give what the JAX
module gives for it alone: the same keypoint set (as sets: the tests
assert that no two kept scores tie and that the K-th score lies further
from the next than the sides' scores differ), scores at the keypoints
within 1e-6 and descriptors within 1e-5. At 64 x 102 the heat map is 96
columns wide: columns 92-95 keep their keypoints (F11) and the flat
indices are decoded with the input's width (F12), on both sides. The JAX
module runs under `jax.jit`, once per shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.superglue import superpoint as tsp
from sam_pt_torch.utils.checkpoint import superpoint_state_dict_from_jax
from sam_pt_tpu.models.tracker.superglue import superpoint as jsp
from sam_pt_tpu.utils.checkpoint import convert_superpoint_state_dict
from torch_port_helpers import random_superpoint_state_dict, torch_sd

torch.set_num_threads(1)

K = 96
SCORE_ATOL = 1e-6
DESC_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    sd = random_superpoint_state_dict(seed=21)
    model = tsp.SuperPoint(max_keypoints=K)
    model.load_state_dict(torch_sd(sd))
    return sd, model.eval(), convert_superpoint_state_dict(sd)


def _jax_per_frame(params, frames):
    apply = jax.jit(jsp.SuperPoint(max_keypoints=K).apply)
    return [{k: np.asarray(v) for k, v in apply(params, f).items()}
            for f in frames]


def _frames(h, w, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, h, w)).astype(np.float32)


def _heat(model, frames):
    with torch.no_grad():
        x = torch.from_numpy(frames)
        return model.heat_map(model.encode(x), frames.shape[1:]).numpy()


@pytest.mark.parametrize("hw", [(96, 128), (64, 102)])
def test_batched_frames_match_the_jax_per_frame_call(weights, hw):
    _, model, params = weights
    frames = _frames(*hw)
    refs = _jax_per_frame(params, frames)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch.from_numpy(frames))
               .items()}
    heat = _heat(model, frames)
    for i, ref in enumerate(refs):
        valid = got["valid"][i]
        np.testing.assert_array_equal(valid, ref["valid"])
        # keypoint sets, and each keypoint's score and descriptor
        order_t = np.lexsort(got["keypoints"][i][valid].T)
        order_j = np.lexsort(ref["keypoints"][valid].T)
        np.testing.assert_array_equal(got["keypoints"][i][valid][order_t],
                                      ref["keypoints"][valid][order_j])
        np.testing.assert_allclose(got["scores"][i][valid][order_t],
                                   ref["scores"][valid][order_j],
                                   atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(got["descriptors"][i][valid][order_t],
                                   ref["descriptors"][valid][order_j],
                                   atol=DESC_ATOL, rtol=0)
        # margins: no tie among the kept scores, and the K-th score apart
        # from the first one left out
        flat = np.sort(heat[i].ravel())[::-1]
        kept = flat[:K][flat[:K] > 0]
        assert np.diff(kept).max() < 0 and (
            flat[K - 1] - flat[K] > 10 * SCORE_ATOL or flat[K - 1] == 0)
        norms = np.linalg.norm(got["descriptors"][i][valid], axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_border_and_decode_of_a_width_not_a_multiple_of_8(weights):
    """F11 and F12 at 64 x 102: the heat map is 96 columns wide; keypoints
    from its columns 92-95 stay, though they lie within 4 pixels of its
    last column, and every index is decoded with the width 102, on both
    sides."""
    _, model, params = weights
    frames = _frames(64, 102, seed=1, n=2)
    refs = _jax_per_frame(params, frames)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    assert _heat(model, frames).shape == (2, 64, 96)
    for i, ref in enumerate(refs):
        for kp, valid in ((got["keypoints"][i].numpy(),
                           got["valid"][i].numpy()),
                          (ref["keypoints"], ref["valid"])):
            xs, ys = kp[valid, 0].astype(int), kp[valid, 1].astype(int)
            column = (ys * 102 + xs) % 96  # the heat map's own column
            assert ((column >= 92) & (column <= 95)).any()
            assert set(xs) - set(range(96))  # x past the heat map's width


def test_nms_is_the_jax_max_pool_test():
    rng = np.random.default_rng(3)
    scores = rng.uniform(0, 1, (2, 20, 24)).astype(np.float32)
    scores[0, 5, 5] = scores[0, 5, 7] = 2.0  # a tie within one window
    got = tsp.simple_nms(torch.from_numpy(scores), 2).numpy()
    for i in range(2):
        ref = np.asarray(jsp.simple_nms(jnp.asarray(scores[i]), 2))
        np.testing.assert_array_equal(got[i], ref)
    assert got[0, 5, 5] == got[0, 5, 7] == 2.0  # F10: ties both stay


def test_carrier_round_trip(weights):
    sd, _, params = weights
    back = superpoint_state_dict_from_jax(params)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
