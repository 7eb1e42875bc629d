"""Port PIPS against the JAX package's at the published widths (latent 128,
mixer 512 x 12, S = 8), same weights (a random public-namespace state dict
through the JAX converter), in float32, on small videos.

The random state dict scales the coordinate outputs of the delta block
and the flow embedding's input columns down (see
`torch_port_helpers.random_pips_state_dict`): at full size the embedding's
frequencies turn float32 summation-order differences into diverging
tracks within a few iterations.

Tolerances: feature maps 1e-4 (values of order 1-10, float32 through the
conv stack); window coordinates 1e-4 px and visibility logits 1e-4 after
6 iterations (measured: 4e-6 and 3e-6); tracker trajectories 1e-4 px
(measured 8e-6) and identical visibility flags.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_pt_torch.models.tracker.pips.model import Pips as TPips
from sam_pt_torch.models.tracker.pips.tracker import (
    PipsPointTracker as TTracker,
)
from sam_pt_torch.utils.checkpoint import pips_state_dict_from_jax
from sam_pt_tpu.models.tracker.pips.model import Pips as JPips
from sam_pt_tpu.models.tracker.pips.tracker import (
    PipsPointTracker as JTracker,
)
from sam_pt_tpu.utils.checkpoint import convert_pips_state_dict
from torch_port_helpers import random_pips_state_dict, torch_sd

torch.set_num_threads(1)


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def _port_tracker(sd, **kwargs):
    tracker = TTracker(stride=4, allow_random_init=True, device="cpu",
                       **kwargs)
    tracker.model.load_state_dict(torch_sd(sd))
    return tracker


class TestModel:
    def test_state_dict_round_trip(self):
        sd = random_pips_state_dict(seed=1)
        prefixed = {f"module.{k}": v for k, v in sd.items()}
        _assert_same(pips_state_dict_from_jax(
            convert_pips_state_dict(prefixed)), sd)

    def test_encoder_and_window(self):
        sd = random_pips_state_dict(seed=1)
        params = convert_pips_state_dict(sd)
        jmodel = JPips(stride=4)
        tmodel = TPips(stride=4)
        tmodel.load_state_dict(pips_state_dict_from_jax(params))
        tmodel.eval()
        rng = np.random.default_rng(0)
        rgbs = rng.uniform(0, 255, (8, 32, 48, 3)).astype(np.float32)
        ref_f = np.array(jmodel.apply(params, jnp.asarray(rgbs),
                                      method=JPips.encode_frames))
        with torch.no_grad():
            got_f = tmodel.encode_frames(torch.from_numpy(rgbs))
        np.testing.assert_allclose(got_f.numpy(), ref_f, atol=1e-4, rtol=0)

        xys = rng.uniform(0, 40, (3, 2)).astype(np.float32)
        feat = rng.standard_normal((3, 128)).astype(np.float32)
        for feat_init in (None, feat):
            ref = jmodel.apply(params, jnp.asarray(ref_f), jnp.asarray(xys),
                               None if feat_init is None
                               else jnp.asarray(feat_init), iters=6)
            with torch.no_grad():
                got = tmodel(torch.from_numpy(ref_f), torch.from_numpy(xys),
                             None if feat_init is None
                             else torch.from_numpy(feat_init), iters=6)
            assert np.abs(np.asarray(ref[0]) - xys[None]).max() > 0.5
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=1e-4, rtol=0)


# Queries on frames 0, 3 and 9 of a 10-frame video: windows of 8 run past
# the end (frames past T dropped), the backward pass fills frames before 3
# and 9, and a query on the last frame has no forward window.
QUERIES = np.array([[[0, 5.0, 6.0], [3, 20.0, 15.0], [9, 40.0, 25.0],
                     [3, 30.0, 10.0]]], np.float32)


@pytest.mark.parametrize("vis_bias", [2.0, -1.0],
                         ids=["visible", "falling_threshold"])
def test_tracker_forward(vis_bias):
    """With the visibility bias at -1 every window's visibilities are
    below 0.9, so each frontier walk lowers the threshold several times
    before it moves."""
    sd = random_pips_state_dict(seed=1, vis_bias=vis_bias)
    jtracker = JTracker(params=convert_pips_state_dict(sd), stride=4)
    ttracker = _port_tracker(sd)
    rgbs = np.random.default_rng(2).integers(
        0, 255, (1, 10, 32, 48, 3)).astype(np.uint8)
    ref_t, ref_v = jtracker.forward(rgbs, QUERIES)
    got_t, got_v = ttracker.forward_device(torch.from_numpy(rgbs), QUERIES)
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    assert (ref_v.mean() > 0.8) == (vis_bias > 0)


def test_features_encoded_once_per_video():
    """The orchestrator's mask batches reuse one video tensor: the
    features are cached on it; another tensor is encoded anew."""
    sd = random_pips_state_dict(seed=1)
    tracker = _port_tracker(sd)
    calls = []
    encode = tracker.model.encode_frames
    tracker.model.encode_frames = lambda x: calls.append(1) or encode(x)
    rgbs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (1, 8, 32, 48, 3)).astype(np.uint8))
    first = tracker.forward_device(rgbs, QUERIES[:, :2] * [[[0, 1, 1]]])
    again = tracker.forward_device(rgbs, QUERIES[:, :2] * [[[0, 1, 1]]])
    assert len(calls) == 1
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    tracker.forward_device(rgbs.clone(), QUERIES[:, :1] * [[[0, 1, 1]]])
    assert len(calls) == 2


def test_checkpoint_directory_loads_its_newest_file(tmp_path):
    """A PIPS checkpoint directory: the highest `model-<step>.pth` wins,
    its `model_state_dict` with DataParallel `module.` prefixes loads as
    it is; a file missing a key is refused."""
    sd = random_pips_state_dict(seed=4)
    old = random_pips_state_dict(seed=5)
    for step, weights in ((900, old), (1000, sd)):
        torch.save({"model_state_dict": {f"module.{k}": torch.from_numpy(v)
                                         for k, v in weights.items()},
                    "optimizer_state_dict": {}},
                   tmp_path / f"model-{step:09d}.pth")
    tracker = TTracker(checkpoint_path=str(tmp_path), stride=4,
                       device="cpu")
    got = tracker.model.state_dict()
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    del sd["norm.weight"]
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "model-000002000.pth")
    with pytest.raises(KeyError, match="norm.weight"):
        TTracker(checkpoint_path=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        TTracker(checkpoint_path=str(tmp_path / "absent"), device="cpu")
