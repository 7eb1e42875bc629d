"""Port PIPS++ against the JAX package's at the published widths (delta
block of 8 residual 1-D blocks from 128 filters), same weights (a random
public-namespace state dict through the JAX converter), in float32.

The delta head is scaled down (`random_pips2_state_dict`), so that random
weights move points by small steps. Windows are kept at 8 frames or more:
instance norm over a window's frames is ill-conditioned for short windows
(at 2 frames it is a sign), where float32 runs part even against the
port's own float64 run.

Tolerances: window coordinates 1e-4 px after 4 iterations (measured
1e-5); the carried features 1e-4; tracker trajectories 1e-4 px (measured
2e-5), visibilities all ones.
"""
import jax.numpy as jnp
import numpy as np
import torch

from sam_pt_torch.models.tracker.pips2.model import PipsPlusPlus as TModel
from sam_pt_torch.models.tracker.pips2.tracker import (
    PipsPlusPlusPointTracker as TTracker,
)
from sam_pt_torch.ops.posemb import posemb_sincos_2d_xy as t_posemb
from sam_pt_torch.utils.checkpoint import pips2_state_dict_from_jax
from sam_pt_tpu.models.tracker.pips2.model import PipsPlusPlus as JModel
from sam_pt_tpu.models.tracker.pips2.tracker import (
    PipsPlusPlusPointTracker as JTracker,
)
from sam_pt_tpu.ops.posemb import posemb_sincos_2d_xy as j_posemb
from sam_pt_tpu.utils.checkpoint import convert_pips2_state_dict
from torch_port_helpers import random_pips2_state_dict, torch_sd

torch.set_num_threads(1)


def test_posemb_sincos_2d_xy():
    xy = np.random.default_rng(0).uniform(-20, 20, (3, 5, 2)).astype(
        np.float32)
    for cat in (False, True):
        np.testing.assert_allclose(
            t_posemb(torch.from_numpy(xy), 128, cat_coords=cat).numpy(),
            np.asarray(j_posemb(jnp.asarray(xy), 128, cat_coords=cat)),
            atol=1e-5, rtol=0)


def test_state_dict_round_trip():
    sd = random_pips2_state_dict(seed=1)
    got = pips2_state_dict_from_jax(convert_pips2_state_dict(
        {f"module.{k}": v for k, v in sd.items()}))
    assert set(got) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_window_with_and_without_carried_features():
    sd = random_pips2_state_dict(seed=1, delta_scale=0.01)
    params = convert_pips2_state_dict(sd)
    tmodel = TModel()
    tmodel.load_state_dict(pips2_state_dict_from_jax(params))
    tmodel.eval()
    rng = np.random.default_rng(0)
    fm = rng.standard_normal((8, 8, 9, 128)).astype(np.float32)
    coords = np.broadcast_to(rng.uniform(0, 64, (1, 3, 2)),
                             (8, 3, 2)).astype(np.float32)
    feats = tuple(rng.standard_normal((8, 3, 128)).astype(np.float32)
                  for _ in range(3))
    for feat_init in (None, feats):
        ref = JModel().apply(params, jnp.asarray(fm), jnp.asarray(coords),
                             None if feat_init is None
                             else tuple(map(jnp.asarray, feat_init)),
                             iters=4)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(fm), torch.from_numpy(coords),
                         None if feat_init is None
                         else tuple(map(torch.from_numpy, feat_init)),
                         iters=4)
        assert np.abs(np.asarray(ref[0]) - coords).max() > 0.2
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-4, rtol=0)
        for g, r in zip(got[1], ref[1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                       rtol=0)


def test_tracker_forward():
    """16 frames resized on the device from 48 x 60 to 64 x 72, windows of
    8 overlapping by one; queries on frames 0, 7 (both directions) and 15
    (the last frame: pinned)."""
    sd = random_pips2_state_dict(seed=1, delta_scale=0.01)
    kwargs = dict(max_sequence_length=8, iters=4, image_size=(64, 72))
    jtracker = JTracker(params=convert_pips2_state_dict(sd), **kwargs)
    ttracker = TTracker(allow_random_init=True, device="cpu", **kwargs)
    ttracker.model.load_state_dict(torch_sd(sd))
    rgbs = np.random.default_rng(2).integers(
        0, 255, (1, 16, 48, 60, 3)).astype(np.uint8)
    qp = np.array([[[0, 5.0, 6.0], [7, 20.0, 15.0], [15, 40.0, 25.0],
                    [7, 30.0, 10.0]]], np.float32)
    ref_t, ref_v = jtracker.forward(rgbs, qp)
    got_t, got_v = ttracker.forward_device(torch.from_numpy(rgbs), qp)
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_allclose(got_t[0, 15, 2].numpy(), qp[0, 2, 1:],
                               rtol=1e-6)
